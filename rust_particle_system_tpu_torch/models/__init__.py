from .sph import SPHFluid

__all__ = ["SPHFluid"]
