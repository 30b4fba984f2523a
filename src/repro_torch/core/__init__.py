"""The paper's planning core, ported: the N-site cluster topology
model, the FABRIC cost model, the plan search generalizing Algorithm 1
and the technique selector (pure Python and numpy, copies of the
reference's modules); the execution plans and their sharding rules
(``plans``, ``sharding``); and the train step (``steps``, imported on
its own: it loads the model), on one device or under the data, zero2,
shard, shard_zero and pipeshard plans on ``torch.distributed``, the
last through the pipeline runtime (``pipeline``)."""
from repro_torch.core.plans import PLANS, MeshSpec, Placement, Plan, get_plan

__all__ = ["MeshSpec", "PLANS", "Placement", "Plan", "get_plan"]
