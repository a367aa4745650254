"""gpcr_tpu_torch — the PyTorch + CUDA port of ``gpcr_tpu``.

The learned point-cloud splat renderer and its trainer on an NVIDIA Hopper
GPU. The JAX package ``gpcr_tpu`` stays the reference; every module here
mirrors its counterpart's name and public layout so the two can be held
against each other on the same inputs.

Layer map (same sub-packages as ``gpcr_tpu``):

- ``gpcr_tpu_torch.ops``        splat math, binning, the stream blend and
                                its replay backward (CUDA kernels
                                ``csrc/stream_blend.cu`` and
                                ``csrc/stream_blend_bwd.cu`` plus their
                                plain PyTorch versions), sparse conv
- ``gpcr_tpu_torch.models``     SparseUNet / PCEncoder as ``nn.Module``s
- ``gpcr_tpu_torch.structures`` Camera / CameraTrajectory / PointCloud /
                                Ray / Mesh (ray-cast and z-buffer ground
                                truth, sampling) / RGBDImage
- ``gpcr_tpu_torch.utils``      SH, rigid motion, CUDA-synchronised timing,
                                media (gif / mp4, tiling), OBJ cleaning
- ``gpcr_tpu_torch.render``     PCMLRender / SimpleRender, checkpoints
- ``gpcr_tpu_torch.train``      losses, Trainer, the data pipeline
- ``gpcr_tpu_torch.io``         the port's own PLY and PNG readers/writers
- ``gpcr_tpu_torch.cli``        the ``pcrender`` / ``simple`` benchmark CLI,
                                the ``train`` CLI and the data tools
                                (``sample_pcd``, ``rescale_ply``,
                                ``pipeline``)

The package imports ``torch`` and never ``jax``, and nothing of the
``gpcr_tpu`` package: it keeps its own copy of what it needs.
"""

__version__ = "0.1.0"
