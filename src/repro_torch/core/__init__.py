"""The paper's planning core, ported: the N-site cluster topology
model, the FABRIC cost model, the plan search generalizing Algorithm 1
and the technique selector.  Pure Python and numpy, copies of the
reference's modules; and the one-device train step (``steps``, imported
on its own: it loads the model).  The torch execution plans (``Plan``,
the pipeline runtime) are ROADMAP queue 1, items 7 and 8."""
from repro_torch.core.plans import Placement

__all__ = ["Placement"]
