"""PoolGroups: coordinated joint allocation for interdependent pools.

The declarative surface is api/poolgroup.py (the PoolGroup CRD), the
batched joint kernel is ops/poolgroup.py, the service seam is
SolverService.poolgroup, and this package's PoolGroupEngine is the
host-side orchestration riding the BatchAutoscaler tick — see
docs/poolgroups.md.

The port's copy of karpenter_tpu/poolgroups/__init__.py, changed only in
its imports.
"""

from karpenter_tpu_torch.poolgroups.engine import PoolGroupEngine

__all__ = ["PoolGroupEngine"]
