"""The host time of the assembly plan's fingerprint, on a split-scale
synthetic train split.

    python -m lirec_tpu_torch.tools.time_plan_fingerprint [--movies 80]

Writes a synthetic MovieGraphs tree whose train split holds ``--movies``
movies of 40 scenes each (80 movies: about 10,800 samples, the size of
the eval split that ``chip_smoke.py`` sweeps), builds the int_rel_ch train
dataset over it, and times on the host clock, in alternating rounds, the
two ways of pickling its reduced state (``data/plan_cache.reduced_state``):

- ``c_pickler_s``: ``pickle.dumps(state, protocol=4)``, the C pickler
  (what the fingerprint hashed while it named the port's own modules);
- ``jax_names_s``: ``plan_cache.jax_names_dumps``, the pure-Python
  pickler that names the port's modules as the JAX package's (what
  ``dataset_fingerprint`` hashes now);

and ``cached_hit_s``, the whole of ``plan_cache.cached_fingerprint`` once
its file is written (the C pickler's hash and the file's read: what every
start-up after the first pays).

It prints the median of each and the bytes pickled as one JSON line. A
host measurement: no card is used.
"""

from __future__ import annotations

import argparse
import json
import pickle
import statistics
import tempfile
import time

SCENES = list(range(2, 82, 2))  # 40 scenes a movie


def measure(movies: int, rounds: int = 5) -> dict:
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.data import plan_cache, synthetic
    from lirec_tpu_torch.data.dataset import InteractionDataset

    with tempfile.TemporaryDirectory() as root:
        spec = synthetic.SyntheticSpec(
            movies={"train": ["tt%07d" % (1000000 + i)
                              for i in range(movies)],
                    "val": ["tt1454029"], "test": ["tt0120338"]},
            scenes=SCENES)
        synthetic.generate(root, spec)
        base = synthetic.make_config(root, spec)
        cfg = config_lib.preset("int_rel_ch", data_root=root)
        cfg = cfg.replace(dims=base.dims, paths=base.paths)
        ds = InteractionDataset(cfg, mode="train")
        ds.cache()
        ds.init_relships()
        times = {"c_pickler_s": [], "jax_names_s": [], "cached_hit_s": []}
        sizes = {}
        plans = plan_cache.plans_dir(ds)
        want = plan_cache.cached_fingerprint(ds, plans)  # writes its file
        assert want == plan_cache.dataset_fingerprint(ds)
        for _ in range(rounds):
            t = time.perf_counter()
            fp = plan_cache.cached_fingerprint(ds, plans)
            times["cached_hit_s"].append(time.perf_counter() - t)
            assert fp == want
            for key, dumps in (
                    ("c_pickler_s", lambda s: pickle.dumps(s, protocol=4)),
                    ("jax_names_s", plan_cache.jax_names_dumps)):
                t = time.perf_counter()
                blob = dumps(plan_cache.reduced_state(ds))
                times[key].append(time.perf_counter() - t)
                sizes[key] = len(blob)
        return {"samples": len(ds), "movies": movies, "rounds": rounds,
                **{k: statistics.median(v) for k, v in times.items()},
                "runs": times, "bytes": sizes}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="time_plan_fingerprint")
    p.add_argument("--movies", type=int, default=80)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    out = measure(args.movies, args.rounds)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
