from .rom import ROM_REGISTRY, DoubleInt2D, RomDynamics, SingleInt2D, make_rom

__all__ = ["ROM_REGISTRY", "RomDynamics", "SingleInt2D", "DoubleInt2D",
           "make_rom"]
