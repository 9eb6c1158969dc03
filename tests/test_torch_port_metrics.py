"""The port's numpy metrics (ct_clip_ut_tpu_torch/utils/metrics.py) against
the JAX package's scikit-learn / tabulate module: every metric within
1e-12, metrics.txt byte for byte. Skips where scikit-learn is absent.

Cases: random scores, tied scores (a few distinct values), a single-class
column (all 0, all 1), all-zero predictions, few samples, and the golden
prediction matrix of tests/test_visualization_golden.py.
"""

import numpy as np
import pytest

from ct_clip_ut_tpu.config import PATHOLOGIES
from ct_clip_ut_tpu_torch.utils import metrics as P

pytest.importorskip("sklearn")
pytest.importorskip("tabulate")
from ct_clip_ut_tpu.utils import metrics as J  # noqa: E402

PATHS = list(PATHOLOGIES)


def _case(name, seed=0, n=40):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, 2, (n, 18))
    preds = rng.random((n, 18))
    if name == "ties":
        preds = np.round(preds * 4) / 4                   # five distinct scores
    elif name == "single_class":
        targets[:, 3] = 0
        targets[:, 7] = 1
    elif name == "zero_preds":
        preds = np.zeros_like(preds)
    elif name == "few":
        targets, preds = targets[:3], preds[:3]
    elif name == "mixed":
        preds[:, :6] = np.round(preds[:, :6], 1)
        targets[:, 0] = 0
        preds[:, 1] = 0.0
    return preds.astype(np.float32), targets


CASES = ["random", "ties", "single_class", "zero_preds", "few", "mixed"]


def _assert_metrics_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12, equal_nan=True, err_msg=k)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_calculate_metrics_matches_sklearn(name, seed):
    preds, targets = _case(name, seed)
    _assert_metrics_equal(P.calculate_metrics(preds, targets, PATHS),
                          J.calculate_metrics(preds, targets, PATHS))


@pytest.mark.parametrize("name", CASES)
def test_save_metrics_is_byte_identical(name, tmp_path):
    history = [J.calculate_metrics(*_case(name, s), PATHS) for s in (0, 1)]
    J.save_metrics(history, PATHS, tmp_path / "jax")
    P.save_metrics(history, PATHS, tmp_path / "port")
    assert ((tmp_path / "port" / "metrics.txt").read_bytes()
            == (tmp_path / "jax" / "metrics.txt").read_bytes())


def test_golden_metrics_txt(tmp_path):
    from test_visualization_golden import GOLDEN, PATHS as GPATHS, _fixed_metrics
    preds, targets = _fixed_metrics()
    P.save_metrics([P.calculate_metrics(preds, targets, GPATHS)], GPATHS, tmp_path)
    assert (tmp_path / "metrics.txt").read_text() == (GOLDEN / "metrics_golden.txt").read_text()


@pytest.mark.parametrize("values", [["0.5000", "1.0000", "0.0001"], ["N/A", "0.7500", "1.0000"],
                                    ["12.5000", "0.1230", "3.0000"]])
def test_grid_table_matches_tabulate(values):
    from tabulate import tabulate
    rows = [[f"name {i}" * (i + 1), v, "0.2500"] for i, v in enumerate(values)]
    assert P.grid_table(rows, ["Pathology", "Value", "X"]) == tabulate(
        rows, headers=["Pathology", "Value", "X"], tablefmt="grid")


def test_roc_curve_drops_collinear_points_as_sklearn():
    from sklearn.metrics import roc_curve
    rng = np.random.default_rng(3)
    y, s = rng.integers(0, 2, 200), np.round(rng.random(200), 2)
    for got, want in zip(P.roc_curve(y, s), roc_curve(y, s)):
        np.testing.assert_array_equal(got, want)
