"""Trigger policies: which leaves an event step proposes to send.

Port of `eventgrad_tpu/parallel/policy.py`, the `norm_delta` subset:
`NormDelta` is the EventGraD trigger whole, delegating to the
`events.propose` / `events.commit` functions. The registry keeps the JAX
package's names; `topk`, `micro` and `hybrid` are not ported yet and
raise.
"""

from __future__ import annotations

from typing import Dict, Optional

from eventgrad_tpu_torch.parallel import events


class NormDelta:
    """The EventGraD norm-delta trigger; its proposal is
    `ops.event_engine.event_propose_pack`."""

    name = "norm_delta"
    algos = ("eventgrad",)

    def commit(self, state, prop, fire_vec, cfg, n_neighbors):
        return events.commit(state, prop, fire_vec, cfg, n_neighbors)


POLICIES: Dict[str, NormDelta] = {NormDelta.name: NormDelta()}

#: registered in the JAX package, not ported yet
UNPORTED = ("topk", "micro", "hybrid")

#: the policy an algo runs when none is named
DEFAULT_FOR_ALGO: Dict[str, str] = {"eventgrad": "norm_delta"}


def resolve(name: Optional[str], algo: str) -> NormDelta:
    """The policy instance `algo` runs: the registered `name`, or the
    algo's default when None. Raises ValueError for unknown names, algos
    without an event trigger and policy/algo mismatches, and
    NotImplementedError for policies not ported yet."""
    if name is None:
        default = DEFAULT_FOR_ALGO.get(algo)
        if default is None:
            raise ValueError(
                f"algo {algo!r} has no event trigger; trigger policies "
                f"apply to {sorted(DEFAULT_FOR_ALGO)}"
            )
        return POLICIES[default]
    if name in UNPORTED:
        raise NotImplementedError(
            f"trigger policy {name!r} is not ported yet (only "
            f"{sorted(POLICIES)})"
        )
    pol = POLICIES.get(name)
    if pol is None:
        raise ValueError(
            f"unknown trigger policy {name!r}; registered: "
            f"{sorted(POLICIES) + list(UNPORTED)}"
        )
    if algo not in pol.algos:
        raise ValueError(
            f"trigger policy {name!r} drives {'/'.join(pol.algos)}, not "
            f"algo {algo!r}"
        )
    return pol
