"""A CPU rehearsal of ``chip_smoke.py`` phase 6b (``bench.py --modes``'
cells) at a tiny size: the same control flow, checks and timing lines, with
``quad_accumulate`` swapped for a plain version that counts its calls as
launches (the CUDA kernel cannot run here)."""

import sys
from pathlib import Path

import torch

import coolpuppy_tpu_torch.ops.quad_gather as qg

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
try:
    import chip_smoke
finally:
    sys.path.remove(str(REPO))


def test_modes_phase_rehearsal(monkeypatch, capsys):
    plain = qg.quad_accumulate_plain

    def counted(*args):
        qg.LAUNCHES += 1
        return plain(*args)

    monkeypatch.setattr(qg, "quad_accumulate", counted)
    full = chip_smoke.modes_workload
    monkeypatch.setattr(chip_smoke, "modes_workload", lambda: full(
        n_sites=120, n_bins=1_200, n_contacts=60_000, n_trans=40,
        trans_size=(600, 500, 30_000, 20_000),
    ))
    launches = chip_smoke.check_modes(torch.device("cpu"), lambda: None,
                                      "cpu rehearsal")
    assert launches == {"stripes": 1, "by_window": 1, "bedpe": 1, "trans": 1}
    out = capsys.readouterr().out
    for cell in chip_smoke.MODES_CELLS:
        assert f"modes {cell} kernel vs plain (whole run)" in out
        assert f"modes {cell} snips/s:" in out
    assert "stripe rows equal stripes_host" in out


def test_rescale_and_wide_phase_rehearsal(monkeypatch, capsys):
    """Phase 7b and 7c at a tiny size: 50 TADs (widths cut to a quarter so
    the extents stay within two 128-bin buckets) held against the host
    loop, and 200 sites at W = 123."""
    full_rescale = chip_smoke.rescale_workload

    def rescale_workload():
        clr, feats = full_rescale(n_tads=50, n_bins=1_500, n_contacts=150_000)
        bins = (feats["end"] - feats["start"]) // clr.binsize
        return clr, feats.assign(end=feats["start"] + bins // 4 * clr.binsize)

    ms = chip_smoke.check_rescale_cell(torch.device("cpu"), lambda: None,
                                       "cpu rehearsal",
                                       workload=rescale_workload)
    assert sorted(ms) == ["local", "local_ooe"]
    monkeypatch.setattr(chip_smoke, "WIDE_CELL_KW", dict(
        chip_smoke.WIDE_CELL_KW, flank=610_000, maxdist=1_500_000))
    chip_smoke.check_wide_cell(
        torch.device("cpu"), lambda: None, "cpu rehearsal",
        workload=lambda: chip_smoke.engine_workload(
            n_sites=200, n_bins=1_500, n_contacts=150_000),
    )
    out = capsys.readouterr().out
    for variant in ("local", "local_ooe"):
        assert f"rescale {variant} checked run:" in out
        assert f"rescale {variant} vs the host loop" in out
        assert f"rescale {variant} rescale_accumulate: device span" in out
        assert f"rescale {variant} snips/s:" in out
    assert "W 123, route generic_torch" in out
    assert "wide generic_accumulate: device span" in out
    assert "wide snips/s:" in out

