"""gpcr_tpu_torch — the PyTorch + CUDA port of ``gpcr_tpu``.

The learned point-cloud splat renderer on an NVIDIA Hopper GPU. The JAX
package ``gpcr_tpu`` stays the reference; every module here mirrors its
counterpart's name and public layout so the two can be held against each
other on the same inputs.

Layer map (same sub-packages as ``gpcr_tpu``):

- ``gpcr_tpu_torch.ops``        splat math, binning, the stream blend
                                (CUDA kernel ``csrc/stream_blend.cu`` plus
                                its plain PyTorch version), sparse conv
- ``gpcr_tpu_torch.models``     SparseUNet / PCEncoder as ``nn.Module``s
- ``gpcr_tpu_torch.structures`` Camera / CameraTrajectory / PointCloud
- ``gpcr_tpu_torch.utils``      SH, rigid motion, CUDA-synchronised timing
- ``gpcr_tpu_torch.render``     PCMLRender / SimpleRender, checkpoints
- ``gpcr_tpu_torch.cli``        the ``pcrender`` / ``simple`` benchmark CLI

The package imports ``torch`` and never ``jax``; it shares only the
host-only, jax-free ``gpcr_tpu.io`` PLY and PNG readers and writers, all
through ``gpcr_tpu_torch.io``.
"""

__version__ = "0.1.0"
