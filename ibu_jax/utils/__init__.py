"""Small host-side utilities (platform selection, timing)."""

from ibu_jax.utils.platform import apply_platform_env

__all__ = ["apply_platform_env"]
