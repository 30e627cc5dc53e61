"""A configuration's corpora, written by the frozen generators (gen/): the
six case-study families, or one synthetic sweep, their runs in an order
drawn from ``--seed``.

The generators run at the configuration's own ``base_seed``, so their
output is the same for every seed: it is generated once per checkout into
a cache (``.portbench-cache/corpora/``, keyed by the configuration and the
generators' source), and each run lays its seed's order over it: a fresh
``runs.json``, and a symbolic link under its new name to each cached run
file."""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import random
import shutil
from concurrent.futures import ThreadPoolExecutor

from portbench.gen import case_studies, synth

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
RUN_FILES = ("pre_provenance.json", "post_provenance.json", "spacetime.dot")


def _write(corpus_dir: str, files: dict) -> None:
    os.makedirs(corpus_dir, exist_ok=True)
    for fname, content in files.items():
        with open(os.path.join(corpus_dir, fname), "w", encoding="utf-8") as f:
            if fname.endswith(".json"):
                json.dump(content, f, indent=1)
            else:
                f.write(content)


def _files(config: dict, name: str) -> dict:
    """The generator's corpus (file name -> content) at the configuration's
    own generator seed."""
    if config["generator"] == "case_studies":
        return case_studies.generate_case_study(case_studies.CASE_STUDIES[name], config["n_runs"],
                                                config["base_seed"])
    if config["generator"] == "synth":
        return synth.generate_corpus(synth.SynthSpec(seed=config["base_seed"], **config["spec"]))
    raise ValueError(f"unknown corpus generator {config['generator']!r}")


def order(n_runs: int, order_seed: str) -> list[int]:
    """The old position of each new one: run 0, the failure-free run Molly
    writes first, stays first; the others are shuffled, and renumbered by
    their new position, as Molly would have numbered them had it injected
    the faults in that order."""
    return [0] + random.Random(order_seed).sample(range(1, n_runs), n_runs - 1)


def cache_key(config: dict) -> str:
    """The configuration's generator inputs and the generators' source: a
    change to either makes a new cache entry."""
    h = hashlib.sha256(json.dumps({k: config.get(k) for k in ("generator", "families", "n_runs", "spec",
                                                                "base_seed")}, sort_keys=True).encode())
    for mod in ("gen/case_studies.py", "gen/synth.py", "corpora.py"):
        with open(os.path.join(BENCH_DIR, mod), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _generate(config: dict, name: str, base_dir: str) -> None:
    """One corpus, generated into ``base_dir``: staged under another name
    and renamed, so a run cut short leaves no half-written entry."""
    stage = base_dir + ".partial"
    shutil.rmtree(stage, ignore_errors=True)
    _write(stage, _files(config, name))
    os.rename(stage, base_dir)


def _lay_out(base_dir: str, name: str, seed: int, out_dir: str) -> dict:
    """The seed's corpus from its cached generation: links to the run
    files under their new numbers and a fresh ``runs.json``."""
    with open(os.path.join(base_dir, "runs.json"), encoding="utf-8") as f:
        runs = json.load(f)
    d = os.path.join(out_dir, name)
    perm = order(len(runs), f"{seed}:{name}")
    _write(d, {"runs.json": [dict(runs[old], iteration=new) for new, old in enumerate(perm)]})
    for new, old in enumerate(perm):
        for kind in RUN_FILES:
            os.symlink(os.path.join(base_dir, f"run_{old}_{kind}"), os.path.join(d, f"run_{new}_{kind}"))
    return {"name": name, "dir": d}


def corpus_names(config: dict) -> list[str]:
    if config["generator"] == "case_studies":
        return list(config["families"])
    return [config["spec"]["name"]]


def write_corpora(config: dict, seed: int, out_dir: str, cache_root: str) -> list[dict]:
    """One record per corpus: {"name", "dir"}, in the
    configuration's order.  Every seed gets the same runs, generated at the
    configuration's ``base_seed``, in an order drawn from ``seed``: the
    work is the same from seed to seed, the answers are not.  Corpora not
    in the cache yet are generated by one spawned worker process each, and
    laid out by one thread each, all joined before this returns."""
    names = corpus_names(config)
    root = os.path.join(os.path.abspath(cache_root), f"{config.get('name', config['generator'])}-{cache_key(config)}")
    bases = {name: os.path.join(root, name) for name in names}
    missing = [name for name in names if not os.path.isdir(bases[name])]
    os.makedirs(root, exist_ok=True)
    if len(missing) == 1:
        _generate(config, missing[0], bases[missing[0]])
    elif missing:
        with multiprocessing.get_context("spawn").Pool(min(len(missing), os.cpu_count() or 1)) as pool:
            pool.starmap(_generate, [(config, name, bases[name]) for name in missing])
    with ThreadPoolExecutor(len(names)) as ex:
        return list(ex.map(lambda name: _lay_out(bases[name], name, seed, out_dir), names))
