"""Training: the loop, checkpoints in the reference's format,
evaluation, cross-plan resharding and elastic re-planning (port of
``repro/train``)."""
from repro_torch.train.checkpoint import (latest_checkpoint,
                                          restore_checkpoint,
                                          save_checkpoint, verify_checkpoint)
from repro_torch.train.evaluate import embed_texts, evaluate_perplexity
from repro_torch.train.loop import TrainResult, model_flops_per_step, train
from repro_torch.train.replan import (ElasticRun, ReplanResult, SiteFailure,
                                      kill_site_at, replan, train_elastic)
from repro_torch.train.reshard import (reshard_checkpoint, reshard_state,
                                       restage, stage_view, unstage_view)

__all__ = ["ElasticRun", "ReplanResult", "SiteFailure", "TrainResult",
           "embed_texts", "evaluate_perplexity", "kill_site_at",
           "latest_checkpoint", "model_flops_per_step", "replan",
           "reshard_checkpoint", "reshard_state", "restage",
           "restore_checkpoint", "save_checkpoint", "stage_view", "train",
           "train_elastic", "unstage_view", "verify_checkpoint"]
