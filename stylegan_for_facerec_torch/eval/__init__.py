from .inference import run_on_batch, tensor2im

__all__ = ["run_on_batch", "tensor2im"]
