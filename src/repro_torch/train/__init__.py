"""Training on one device: the loop, checkpoints in the reference's
format, and evaluation (port of ``repro/train``; resharding and
replanning wait for ROADMAP queue 1, item 11)."""
from repro_torch.train.checkpoint import (latest_checkpoint,
                                          restore_checkpoint,
                                          save_checkpoint, verify_checkpoint)
from repro_torch.train.evaluate import embed_texts, evaluate_perplexity
from repro_torch.train.loop import TrainResult, model_flops_per_step, train

__all__ = ["TrainResult", "embed_texts", "evaluate_perplexity",
           "latest_checkpoint", "model_flops_per_step", "restore_checkpoint",
           "save_checkpoint", "train", "verify_checkpoint"]
