"""Elastic scaling plans (port of ``repro/runtime/elastic.py``).

Policy: an elastic axis (the reference's ``pod``, the serving fleet's
``replica``) is the unit of growth and loss; the ``model`` axis is fixed by
the architecture's tensor-parallel requirement.  The serving fleet
(:mod:`repro_torch.cluster`) records every grow, shrink and replacement as
a validated :class:`ElasticPlan` over a ``replica`` axis.

Re-placing a tree's leaves for a new mesh (the reference's
``reshard_tree``) needs the port's sharding rules, which come with tensor
parallelism (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass
class ElasticPlan:
    old_axes: Dict[str, int]
    new_axes: Dict[str, int]

    @property
    def scale_factor(self) -> float:
        old = 1
        for v in self.old_axes.values():
            old *= v
        new = 1
        for v in self.new_axes.values():
            new *= v
        return new / old

    def batch_advice(self, global_batch: int) -> int:
        """Keep per-device batch constant: rescale the global batch.

        Rounds to nearest — truncation would bias every non-integer scale
        factor downward (e.g. 3 -> 2 pods at global batch 4 truncated to
        2 instead of 3, shrinking the per-device batch by a third)."""
        return max(1, round(global_batch * self.scale_factor))

    def validate(self, model_axis: str = "model"):
        if self.old_axes.get(model_axis) != self.new_axes.get(model_axis):
            raise ValueError(
                "elastic re-mesh must preserve the model axis "
                f"({self.old_axes.get(model_axis)} -> "
                f"{self.new_axes.get(model_axis)}); TP degree is fixed by "
                "the architecture")


def reshard_tree(abstract_tree, concrete_tree, rules, new_mesh):
    """Re-place every leaf of ``concrete_tree`` for ``new_mesh``: not in
    the port yet."""
    raise NotImplementedError(
        "reshard_tree needs the port's sharding rules and meshes, which "
        "come with tensor-parallel serving (ROADMAP Queue 1 item 13)")
