from . import maths
from .rom import (
    ROM_REGISTRY,
    DoubleInt2D,
    ExtendedLateralUnicycle,
    ExtendedUnicycle,
    LateralUnicycle,
    RomDynamics,
    SingleInt2D,
    Unicycle,
    make_rom,
)

__all__ = ["maths", "ROM_REGISTRY", "RomDynamics", "SingleInt2D",
           "DoubleInt2D", "Unicycle", "LateralUnicycle", "ExtendedUnicycle",
           "ExtendedLateralUnicycle", "make_rom"]
