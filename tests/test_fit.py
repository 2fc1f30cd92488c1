"""Gates for the production-fit harness (benchmarks/fit_scale.py).

The full-scale fit (slab dx=0.2 / LV, full-beat TP06, 12 Adam
iterations) runs on the accelerator via
``python -m fenicsx_beat_tpu.benchmarks.fit_scale``; these gates pin the
machinery at CI scale:

* the windowed-BPTT gradient DESCENDS the true objective (cosine vs
  central FD of the total loss > 0, per-component signs match),
* a short Adam fit on the toy slab decreases the loss with finite
  gradients throughout.
"""

import numpy as np
import pytest

from fenicsx_beat_tpu.benchmarks.fit_scale import run_fdcheck, run_fit


@pytest.mark.slow
def test_windowed_gradient_descends_true_objective():
    row = run_fdcheck(dx=1.0, T=30.0, window_ms=20.0, rel_eps=0.05)
    assert row["signs_match"], row
    assert row["cosine_log_space"] > 0.7, row


@pytest.mark.slow
def test_fit_decreases_loss_toy_scale():
    row = run_fit(
        case="slab", dx=1.0, T=20.0, segment_ms=10.0, window_ms=20.0,
        n_iters=3, lr=0.15,
    )
    assert row["all_grads_finite"], row
    assert row["loss_last"] < row["loss_first"], row
    losses = [h["loss"] for h in row["history"]]
    assert all(np.isfinite(losses)), losses
