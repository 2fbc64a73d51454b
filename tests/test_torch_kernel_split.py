"""``chip_smoke.py``'s per-kernel split of a profile, on fake profiler rows.

``split_rows`` turns the profiler's (name, device microseconds, launches
recorded) rows over ``calls`` calls into milliseconds per call by kernel
name, and names the kernels whose recorded count is not a whole multiple
of ``calls``: those lost records, and ``kernel_split`` profiles again
rather than report a split that reads low. Importing ``chip_smoke.py``
runs no device code: its phases live in ``main()``.
"""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("calls", [1, 10])
def test_fake_rows_split_exactly(calls):
    rows = [("attn_wg_kernel<3, 32>", 1000.0 * calls, calls),
            ("wgrad_kernel(...)", 250.0 * calls, 2 * calls),
            ("colsum_kernel", 12.5 * calls, 3 * calls),
            # a name that the profiler reports in two rows sums over both
            ("wgrad_kernel(...)", 50.0 * calls, calls)]
    split, counts, lost = _chip_smoke().split_rows(rows, calls)
    assert split == pytest.approx({"attn_wg_kernel<3, 32>": 1.0, "wgrad_kernel(...)": 0.3,
                                   "colsum_kernel": 0.0125}, rel=1e-12)
    assert list(split) == ["attn_wg_kernel<3, 32>", "wgrad_kernel(...)", "colsum_kernel"]
    assert counts == {"attn_wg_kernel<3, 32>": calls, "wgrad_kernel(...)": 3 * calls,
                      "colsum_kernel": 3 * calls}
    assert lost == []


@pytest.mark.parametrize("recorded", [8, 19, 21])
def test_a_count_short_of_a_multiple_of_calls_is_caught(recorded):
    """K4b's phase recorded 8 of its 10 launches once: its split read 20%
    low. Any count that is not a whole multiple of the calls is caught."""
    rows = [("swin_fwd_h32_wg_kernel<3, 32>", 800.0, recorded),
            ("mlp_bwd_f32_kernel<3>", 1000.0, 10)]
    _, counts, lost = _chip_smoke().split_rows(rows, 10)
    assert lost == ["swin_fwd_h32_wg_kernel<3, 32>"]
    assert counts["swin_fwd_h32_wg_kernel<3, 32>"] == recorded


def test_importing_chip_smoke_runs_no_device_code(capsys):
    mod = _chip_smoke()
    assert callable(mod.main) and callable(mod.kernel_split)
    assert capsys.readouterr().out == ""
