from .inference import face_grid, run_on_batch, tensor2im

__all__ = ["face_grid", "run_on_batch", "tensor2im"]
