"""Executable walkthrough of the PyTorch port: the steps of
``docs/walkthrough.py`` through ``coolpuppy_tpu_torch``.

Writes a synthetic cooler and stranded features, then drives every user
surface end to end on the CPU: the ``coolpup-torch`` CLI with ``--device
cpu`` (plain, by strand and distance, stripes, local rescale; a
``path::group`` URI), ``dividepups-torch``, ``plotpup-torch``, and the Python
API through the notebook aliases on ``Cooler(uri)`` with an extension hook.
Run it with ``python docs/walkthrough_torch.py``; exit code 0 = all good.
"""

import os
import sys
import tempfile

import numpy as np
import pandas as pd


def main():
    from coolpuppy_tpu_torch import Cooler, write_cool
    from coolpuppy_tpu_torch.cli import (coolpup_cli, dividepups_cli,
                                         plotpup_cli)
    from coolpuppy_tpu_torch.coolpup import CoordCreator, PileUpper, pileup
    from coolpuppy_tpu_torch.lib.io import load_pileup_df

    tmp = tempfile.mkdtemp(prefix="coolpuppy_tpu_torch_walkthrough_")
    os.chdir(tmp)

    # 1. synthetic cooler (distance-decaying contacts) + stranded features
    rng = np.random.default_rng(0)
    n_bins, binsize = 2_000, 100_000
    i, j = np.triu_indices(n_bins)
    vals = rng.poisson(200.0 / (1.0 + np.abs(i - j)) + 0.2)
    keep = vals > 0
    weights = rng.uniform(0.5, 1.5, n_bins)
    weights[rng.random(n_bins) < 0.03] = np.nan
    pixels = (i[keep], j[keep], vals[keep])
    write_cool("toy.cool", {"chr1": n_bins * binsize}, binsize, pixels,
               weights=weights)
    # the same map in one group of a multi-resolution file
    write_cool("toy.mcool", {"chr1": n_bins * binsize}, binsize, pixels,
               weights=weights, group="/resolutions/100000")
    clr = Cooler("toy.cool")

    centers = np.sort(rng.choice(np.arange(50, n_bins - 50), 200, False))
    feats = pd.DataFrame(
        {
            "chrom": "chr1",
            "start": centers * binsize,
            "end": centers * binsize + binsize,
            "name": ".",
            "score": 0,
            "strand": rng.choice(["+", "-"], len(centers)),
        }
    )
    feats.to_csv("features.bed", sep="\t", header=False, index=False)
    tads = pd.DataFrame(
        {
            "chrom": "chr1",
            "start": centers[:50] * binsize,
            "end": (centers[:50] + rng.integers(5, 30, 50)) * binsize,
        }
    )
    tads.to_csv("tads.bed", sep="\t", header=False, index=False)

    cpu = " --device cpu"
    # 2. CLI: plain pileup with shifted controls
    coolpup_cli.main(
        ("toy.cool features.bed --flank 1000000 --nshifts 2 --seed 0"
         " -o plain.clpy" + cpu).split()
    )
    # 3. CLI: by-strand x by-distance
    coolpup_cli.main(
        ("toy.cool features.bed --flank 1000000 --nshifts 1 --seed 0"
         " --by_strand --by_distance -o bsbd.clpy" + cpu).split()
    )
    # 4. CLI: stripes
    coolpup_cli.main(
        ("toy.cool features.bed --flank 1000000 --nshifts 1 --seed 0"
         " --store_stripes -o stripes.clpy" + cpu).split()
    )
    # 5. CLI: local rescaled TADs
    coolpup_cli.main(
        ("toy.cool tads.bed --local --rescale --rescale_size 33"
         " --rescale_flank 1 --seed 0 -o tads.clpy" + cpu).split()
    )
    # 6. CLI: the multi-resolution file's group gives the same pileup
    coolpup_cli.main(
        ("toy.mcool::/resolutions/100000 features.bed --flank 1000000"
         " --nshifts 2 --seed 0 -o mcool.clpy" + cpu).split()
    )
    # 7. divide two pups
    dividepups_cli.main(["plain.clpy", "plain.clpy", "-o", "ratio.clpy"])
    # 8. plots
    plotpup_cli.main(
        "--input_pups bsbd.clpy --rows orientation --cols separation"
        " --no_score --output grid.png".split()
    )
    plotpup_cli.main(
        "--input_pups stripes.clpy --stripe corner_stripe --lineplot"
        " --no_score --output stripes.png".split()
    )

    # 9. Python API + extension hook (per-snip domain score)
    from functools import partial

    from coolpuppy_tpu_torch.lib.numutils import get_domain_score
    from coolpuppy_tpu_torch.lib.puputils import accumulate_values

    pups = pileup(
        clr, feats, features_format="bed", flank=1_000_000, nshifts=1,
        seed=0, device="cpu",
    )
    assert int(pups.loc[pups["group"] == "all", "n"].iloc[0]) > 0

    cc = CoordCreator(
        tads, binsize, features_format="bed", local=True, rescale_flank=1,
        nshifts=0, mindist=0,
    )
    pu = PileUpper(clr, cc, rescale=True, rescale_size=33, device="cpu")

    def add_score(snip):
        snip["domain_score"] = get_domain_score(snip["data"], 1)
        return snip

    scored = pu.pileupsWithControl(
        postprocess_snip_func=add_score,
        extra_sum_funcs={
            "domain_score": partial(accumulate_values, key="domain_score")
        },
    )
    scores = scored.set_index("group").loc["all", "domain_score"]
    assert len(scores) == len(tads)

    # 10. everything wrote loadable outputs
    for f in ("plain.clpy", "bsbd.clpy", "stripes.clpy", "tads.clpy",
              "mcool.clpy", "ratio.clpy"):
        df = load_pileup_df(f)
        assert len(df) > 0
    plain, mcool = load_pileup_df("plain.clpy"), load_pileup_df("mcool.clpy")
    np.testing.assert_array_equal(plain["n"], mcool["n"])
    np.testing.assert_allclose(np.stack(plain["data"]),
                               np.stack(mcool["data"]), rtol=1e-6,
                               equal_nan=True)
    for f in ("grid.png", "stripes.png"):
        assert os.path.getsize(f) > 0

    # the port imports neither jax nor the JAX package
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "coolpuppy_tpu")]
    print("walkthrough_torch ok:", tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
