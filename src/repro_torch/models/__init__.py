from . import simple_nn

__all__ = ["simple_nn"]
