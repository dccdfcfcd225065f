from .fid import embedding_fid, frechet_distance, gaussian_stats
from .inference import encoder_bootstrap, face_grid, run_on_batch, tensor2im
from .verification import evaluate
from .verify_runner import (compute_embeddings, get_rfw_val_data,
                            load_val_pair, make_embed_fn, perform_val)

__all__ = ["compute_embeddings", "embedding_fid", "encoder_bootstrap",
           "evaluate", "face_grid",
           "frechet_distance", "gaussian_stats", "get_rfw_val_data",
           "load_val_pair", "make_embed_fn", "perform_val", "run_on_batch",
           "tensor2im"]
