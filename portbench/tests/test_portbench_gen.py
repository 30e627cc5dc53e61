"""The frozen generators write, byte for byte, the corpora of the program's
own generators (nemo_tpu_torch/models/) at small sizes, and a seed only
reorders a configuration's runs."""

import json
import os

import pytest

from nemo_tpu_torch.models.case_studies import CASE_STUDIES, write_case_study
from nemo_tpu_torch.models.synth import SynthSpec, write_corpus
from portbench import corpora


def tree(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


@pytest.mark.parametrize("base_seed", [0, 4294967311])
def test_case_studies_byte_equal(tmp_path, base_seed):
    cfg = {"generator": "case_studies", "families": list(CASE_STUDIES), "n_runs": 30, "base_seed": base_seed}
    for name in CASE_STUDIES:
        ours = str(tmp_path / "ours" / name)
        corpora._write(ours, corpora._files(cfg, name))
        theirs = write_case_study(name, 30, base_seed, str(tmp_path / "theirs"))
        assert tree(ours) == tree(theirs)


@pytest.mark.parametrize("base_seed", [0, 6])
def test_synth_byte_equal(tmp_path, base_seed):
    spec = {"n_runs": 30, "eot": 80, "eff": 4, "name": "pb_long"}
    cfg = {"generator": "synth", "spec": spec, "base_seed": base_seed}
    ours = str(tmp_path / "ours")
    corpora._write(ours, corpora._files(cfg, "pb_long"))
    theirs = write_corpus(SynthSpec(seed=base_seed, **spec), str(tmp_path / "theirs"))
    assert tree(ours) == tree(theirs)


def test_a_seed_reorders_the_same_runs(tmp_path):
    cfg = {"generator": "synth", "spec": {"n_runs": 40, "eot": 12, "name": "s"}, "base_seed": 3}
    cache = str(tmp_path / "cache")
    (a,) = corpora.write_corpora(cfg, 1, str(tmp_path / "a"), cache)
    (b,) = corpora.write_corpora(cfg, 2, str(tmp_path / "b"), cache)
    (a2,) = corpora.write_corpora(cfg, 1, str(tmp_path / "a2"), str(tmp_path / "another-cache"))
    ta, tb = tree(a["dir"]), tree(b["dir"])
    assert ta == tree(a2["dir"]) and ta != tb
    assert sorted(ta.values()) != sorted(tb.values())  # runs.json differs by order
    del ta["runs.json"], tb["runs.json"]
    assert sorted(ta.values()) == sorted(tb.values()) and ta["run_0_pre_provenance.json"] == tb["run_0_pre_provenance.json"]
    runs = json.loads(tree(b["dir"])["runs.json"])
    assert [r["iteration"] for r in runs] == list(range(40))


def test_the_cache_holds_the_generation_once(tmp_path):
    cfg = {"name": "fam", "generator": "case_studies", "families": ["ZK-1270-racing-sent-flag", "MR-3858-hadoop"],
           "n_runs": 20, "base_seed": 0}
    cache = str(tmp_path / "cache")
    first = corpora.write_corpora(cfg, 5, str(tmp_path / "a"), cache)
    (entry,) = os.listdir(cache)
    assert entry == f"fam-{corpora.cache_key(cfg)}"
    base = os.path.join(cache, entry)
    assert sorted(os.listdir(base)) == sorted(cfg["families"])
    stamps = {(d, f): os.stat(os.path.join(base, d, f)).st_mtime_ns for d in cfg["families"]
              for f in os.listdir(os.path.join(base, d))}
    again = corpora.write_corpora(cfg, 5, str(tmp_path / "b"), cache)
    assert [tree(c["dir"]) for c in first] == [tree(c["dir"]) for c in again]
    assert stamps == {(d, f): os.stat(os.path.join(base, d, f)).st_mtime_ns for d, f in stamps}
    # the run files are the cached ones, under their new numbers
    perm = corpora.order(20, "5:MR-3858-hadoop")
    assert os.path.samefile(os.path.join(again[1]["dir"], "run_3_spacetime.dot"),
                            os.path.join(base, "MR-3858-hadoop", f"run_{perm[3]}_spacetime.dot"))
    assert corpora.cache_key(cfg | {"n_runs": 21}) != corpora.cache_key(cfg)


def test_a_cut_generation_is_made_again(tmp_path):
    cfg = {"name": "fam", "generator": "case_studies", "families": ["MR-3858-hadoop"], "n_runs": 10, "base_seed": 0}
    cache = str(tmp_path / "cache")
    root = os.path.join(cache, f"fam-{corpora.cache_key(cfg)}")
    os.makedirs(os.path.join(root, "MR-3858-hadoop.partial"))
    (c,) = corpora.write_corpora(cfg, 2, str(tmp_path / "a"), cache)
    assert sorted(os.listdir(root)) == ["MR-3858-hadoop"]
    assert json.loads(tree(c["dir"])["runs.json"])[0]["iteration"] == 0
