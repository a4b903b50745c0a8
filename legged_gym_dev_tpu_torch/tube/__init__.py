from .models import MLP, softplus_beta

__all__ = ["MLP", "softplus_beta"]
