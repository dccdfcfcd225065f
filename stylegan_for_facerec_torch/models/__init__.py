from .psp import PSp, build_psp, n_styles_for, style_spatial_for

__all__ = ["PSp", "build_psp", "n_styles_for", "style_spatial_for"]
