"""The paper's planning core, ported: the N-site cluster topology
model, the FABRIC cost model, the plan search generalizing Algorithm 1
and the technique selector.  Pure Python and numpy, copies of the
reference's modules; the torch execution plans (``Plan``, the step
builders, the pipeline runtime) come with the training slice."""
from repro_torch.core.plans import Placement

__all__ = ["Placement"]
