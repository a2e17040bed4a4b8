"""The port's supervised soak (`eventgrad_tpu_torch/utils/soak.py`)
against the JAX soak's schema and verdicts.

  * the smoke leg (4 ranks, 6 epochs, 6 membership transitions, a flaky
    window, one crash under the supervisor) runs on the CPU and its
    record validates against `tools/validate_artifacts.SOAK_SCHEMA`,
    with `utils/soak.verdicts` agreeing;
  * the committed full run, `artifacts/torch_soak_cpu.json`, validates
    too and meets the JAX artifact's (`artifacts/soak_cpu.json`)
    verdicts: recovery, bitwise replay and the active ranks verified, as
    many transitions, joins and restarts, no epoch lost to a membership
    transition. Its accuracy: the soak's seed 0 lands in the MLP's
    dead-logit mode (90.625) where the JAX run's draw reached 100, so it
    is held as the faulted op points are (the port's CPU seeds 0-9
    minimum less 4.0), and the median of those seeds to the JAX run's
    accuracy less 4.0.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from eventgrad_tpu_torch.utils import soak

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def va():
    spec = importlib.util.spec_from_file_location(
        "validate_artifacts",
        os.path.join(_ROOT, "tools", "validate_artifacts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(name):
    with open(os.path.join(_ROOT, "artifacts", name)) as f:
        return json.load(f)


def test_soak_smoke_schema_valid(tmp_path, va):
    out = soak.run_soak(str(tmp_path / "soak.json"), mode="smoke",
                        workdir=str(tmp_path / "w"), device="cpu")
    assert va.validate(out, va.SOAK_SCHEMA) == [], out
    assert soak.verdicts(out) == []
    assert out["op_point"]["membership"] == soak.OP_POINTS["smoke"][
        "membership"]
    assert out["supervisor_restarts"] == 1
    with open(tmp_path / "soak.json") as f:
        assert json.load(f) == out


def test_committed_artifact_meets_jax_verdicts(va):
    ours, theirs = _load("torch_soak_cpu.json"), _load("soak_cpu.json")
    assert va.validate(ours, va.SOAK_SCHEMA) == []
    assert soak.verdicts(ours) == []
    assert (ours["mode"], ours["platform"]) == ("full", "cpu")
    assert ours["op_point"] == theirs["op_point"]
    for key in ("recovery_ok", "replay_bitwise", "active_ranks_verified"):
        assert ours[key] is theirs[key] is True, key
    for key in ("n_transitions", "n_joins", "supervisor_restarts",
                "supervisor_escalations"):
        assert ours[key] == theirs[key], key
    memb = [t for t in ours["transitions"] if t["kind"] != "restart"]
    assert memb and all(t["lost_epochs"] == 0 for t in memb)
    # the op point's ReLU-logit MLP is bimodal over the draw of its
    # initial weights (a dead logit class ends near 90%), and the port
    # draws its own: the transitions cost nothing against the same
    # draw's baseline (the schema's 0.5 point gap), the soak holds the
    # faulted op points' rule (PERF.md §2: at least the port's CPU seeds'
    # minimum less 4.0), and the port's typical seed reaches the JAX
    # run's accuracy less 4.0
    seeds = ours["final_acc_baseline_seeds"]
    assert len(seeds) == 10 and seeds[0] == ours["final_acc_baseline"]
    assert ours["final_acc_soak"] >= min(seeds) - 4.0
    assert float(np.median(seeds)) >= theirs["final_acc_soak"] - 4.0
