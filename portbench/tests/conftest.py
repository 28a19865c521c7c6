"""Small shapes of the benchmark's cells, run on the CPU with the
program's plain versions."""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

#: a cell held out of BENCHMARK.json until its knee is found again at its
#: configuration's size; the tests keep running its code, under the
#: end-to-end and per-layer metrics it would report
LATER = {"mf-netflix.serve": (
    {"name": "mf-netflix.serve", "config": "mf-netflix-k40",
     "traffic": "recommend-zipf-open", "chips": 1,
     "why": "MF training while recommend queries arrive"},
    ("query_p95_ms", "device_idle_share", "host_launches_per_round",
     "round_mfu", "serve_batch_ms", "publish_ms"))}


def with_later(bench: dict) -> dict:
    """``bench`` with the cells of :data:`LATER` added."""
    bench = copy.deepcopy(bench)
    for name, (entry, metrics) in LATER.items():
        bench["workloads"].append(entry)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in metrics and "workloads" in m:
                m["workloads"].append(name)
    return bench


def _load(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def small_config(name: str, **over) -> dict:
    """The named configuration at a size the CPU tests hold."""
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = _load(entry["file"])
    if cfg["kind"] == "lda":
        cfg.update(vocab=40, num_topics=8, num_workers=4,
                   tokens_per_worker=64, docs_per_worker=8, warm_rounds=4,
                   check_sample=4)
    else:
        cfg.update(users=64, movies=24, rank=4, source_users=64,
                   source_ratings=64 * 24 * 0.3, check_sample=4)
    cfg.update(over)
    return cfg


def small_mix(name: str, **over) -> dict:
    mix = _load(f"portbench/traffic/{name}.json")
    if "query" in mix and mix["query"]["kind"] == "document":
        mix["query"]["length"].update(max=32, mean=10)
    if "arrivals" in mix:
        mix["arrivals"]["rate_per_s"] = 200.0
        mix["schedule_extra_s"] = 2
    mix.update(over)
    return mix


def small_run(workload: str, seed: int = 2**31 + 11, seconds: float = 0.3,
              config: dict = None, mix: dict = None, traced: bool = False,
              **kw):
    """A ``harness.Run`` of ``workload`` at small shapes on the CPU."""
    from portbench import harness
    bench = with_later(BENCH)
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    return harness.Run(workload, seed, seconds, traced, device="cpu",
                       bench=bench,
                       config=config or small_config(entry["config"]),
                       mix=mix or small_mix(entry["traffic"]), **kw)


@pytest.fixture
def bench():
    return copy.deepcopy(BENCH)
