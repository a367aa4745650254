def _get_pallas_raster():
    """The rasterizer behind ``render_views_fused(use_pallas=True)``: the
    aligned all-tiles blend, the counterpart of the JAX package's
    ``rasterize_gaussians_pallas``."""
    from ..ops.rasterize_aligned import rasterize_gaussians_aligned

    return rasterize_gaussians_aligned
