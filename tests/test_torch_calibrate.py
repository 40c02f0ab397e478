"""The port's calibration fitter (``repro_torch.launch.calibrate``)
against the reference's (``benchmarks/algo_suite.py``).

* ``fit_profile`` on a fixed samples dict writes the same JSON as the
  reference's ``emit_calibration`` on the same dict, ``source`` apart;
  empty samples give the analytic defaults in both;
* the sweep at 2,000 vertices on the CPU runs, its modeled costs equal
  the reference planner's on the same graph, and the profile it writes
  round-trips and bumps ``calibration_generation()`` when loaded;
* the checked-in profile parses and names the NVIDIA card it was fitted
  on and that card's power limit;
* walls of variants that fell back to dense (past the ELL budget) are
  no superstep samples.

Tolerance: none (the fit is the same float arithmetic on the same
numbers; the modeled costs are the same cost model on equal stats).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import algo_suite  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.launch import calibrate as C  # noqa: E402
from repro_torch.data import synthetic as S  # noqa: E402


@pytest.fixture(autouse=True)
def _analytic_calibration():
    """Pin both packages' planners to their analytic constants."""
    JP.set_calibration(None)
    TP.set_calibration(None)
    yield
    JP.set_calibration(None)
    TP.set_calibration(None)


SAMPLES = {
    "full": {
        "bfs": [(0.0021, 0.00031), (0.0075, 0.0009)],
        "connected_components": [(0.011, 0.0004), (0.03, 0.0012),
                                 (0.02, 0.0)],
        "pagerank": [(0.004, 0.002)],
        "_superstep_times": [
            {"dense": 0.003, "fused": 0.001, "frontier": 0.0035},
            {"dense": 0.006, "fused": 0.0025, "frontier": 0.0061},
            {"dense": 0.0, "fused": 0.001, "frontier": 0.001}],
        "_count_times": [0.0004, 0.019, 0.0031]},
    "no_counts": {
        "sssp": [(0.5, 0.1), (0.9, 0.2), (0.3, 0.1), (0.4, 0.1)],
        "_superstep_times": [{"dense": 2.0, "fused": 1.0,
                              "frontier": 3.0}]},
    "tiny_counts": {"k_core": [(1e-5, 1e-6)],
                    "_count_times": [1e-6, 2e-5]},
    "only_supersteps": {"_superstep_times": [
        {"dense": 1.0, "fused": 0.25, "frontier": 4.0},
        {"dense": 1.0, "fused": 0.75, "frontier": 2.0}]},
    "empty_lists": {"bfs": [], "_count_times": [],
                    "_superstep_times": []},
    "empty": {},
}


def _json_without_source(write, tmp_path, name):
    path = tmp_path / name
    write(path)
    d = json.loads(path.read_text())
    d.pop("source")
    return d


@pytest.mark.parametrize("case", sorted(SAMPLES))
def test_fit_profile_writes_the_reference_json(case, tmp_path):
    samples = SAMPLES[case]
    want = _json_without_source(
        lambda p: algo_suite.emit_calibration(p, samples, out=lambda s: None),
        tmp_path, "ref.json")
    got = _json_without_source(lambda p: C.fit_profile(samples).to_json(p),
                               tmp_path, "port.json")
    assert got == want


def test_empty_samples_give_the_analytic_defaults(tmp_path):
    got = C.fit_profile({}, source=TP.CalibrationProfile().source)
    assert got == TP.CalibrationProfile()
    ref = algo_suite.emit_calibration(tmp_path / "ref.json", {},
                                      out=lambda s: None)
    assert ref.algo_time_scale == {} and ref.superstep_edge_bytes == {}
    assert ref.interactive_threshold_s == \
        JP.CalibrationProfile().interactive_threshold_s


@pytest.mark.parametrize("text,want", [
    ("2**18,2**20", [2 ** 18, 2 ** 20]),
    ("2000", [2000]),
    (" 2000, 20000 ", [2000, 20000]),
])
def test_parse_scales(text, want):
    assert C.parse_scales(text) == want


def test_sweep_on_the_cpu_writes_a_loadable_profile(tmp_path):
    out = tmp_path / "profile.json"
    lines = []
    samples = C.collect_samples([2000], "cpu", out=lines.append)
    # the modeled half of each sample is the reference planner's cost on
    # the same graph under the analytic profile
    for name, pairs in samples.items():
        if name.startswith("_"):
            continue
        defn = C.R.get(name)
        src, dst = S.user_follow_graph(2000, 4.0, seed=1)
        keep = src != dst
        jg = JG.build_coo(src[keep], dst[keep], 2000,
                          symmetrize=defn.requires_symmetric)
        stats = JP.GraphStats.of(jg)
        spec = JP.best_spec_for_engine(
            stats, JP.specs_for(name, stats, **dict(defn.example_params)),
            "local")
        want = JP.estimate_local_cost(stats, spec,
                                      profile=JP.CalibrationProfile())
        assert [m for _, m in pairs] == [want], name
        assert all(t > 0 for t, _ in pairs)
    names = {n for n, d in C.suite()}
    assert set(k for k in samples if not k.startswith("_")) == names
    assert len(samples["_superstep_times"]) == 4      # bfs, cc, k-core, sssp
    assert len(samples["_count_times"]) == 4          # the count paths
    assert any(ln.startswith("calibrate/pagerank_local_v2000,")
               for ln in lines)

    gen0 = TP.calibration_generation()
    profile = C.main(["--scales", "2000", "--repeats", "1", "--device",
                      "cpu", "--out", str(out)])
    assert profile.source.endswith("--scales 2000 --repeats 1 on cpu")
    assert set(profile.algo_time_scale) == names
    assert set(profile.superstep_edge_bytes) == {"dense", "fused",
                                                 "frontier"}
    again = TP.CalibrationProfile.from_json(out)
    assert again == profile
    loaded = TP.load_calibration(out)
    assert TP.calibration_generation() == gen0 + 1
    assert TP.active_calibration() is loaded and loaded == profile
    # the reference's loader reads the port's file as its own
    assert JP.CalibrationProfile.from_json(out).superstep_edge_bytes == \
        dict(profile.superstep_edge_bytes)


def test_checked_in_profile_names_the_card():
    ref = TP.CalibrationProfile.from_json(TP.reference_profile_path())
    assert TP.AUTO_LOADED_REFERENCE
    assert ref.source.startswith("repro_torch/launch/calibrate.py --scales")
    assert "NVIDIA" in ref.source and ref.source.rstrip().endswith("W")
    assert set(ref.algo_time_scale) == {n for n, _ in C.suite()}
    assert np.isfinite(ref.interactive_threshold_s)


def test_fallen_back_variants_are_not_samples(monkeypatch):
    """Past ``SUPERSTEP_ELL_BUDGET`` the engine runs fused and frontier
    as dense; such walls are dense's and the sweep leaves them out, so
    the fit keeps the analytic factors where no variant ran."""
    monkeypatch.setattr(engines, "SUPERSTEP_ELL_BUDGET", 0)
    lines = []
    samples = C.collect_samples([500], "cpu", out=lines.append)
    assert "_superstep_times" not in samples
    assert any("_fused_v500," in ln and ln.endswith("realized=dense")
               for ln in lines)
    profile = C.fit_profile(samples)
    assert profile.superstep_edge_bytes == {}
    assert profile.superstep_factor("fused") == \
        TP.CalibrationProfile().superstep_factor("fused")


def test_repeats_keep_the_median_of_each_samples_walls(monkeypatch):
    """With ``repeats`` each sample's wall is the median over the
    sweep's passes (one sample a scale, as without them)."""
    walls = iter(range(1, 10 ** 6))

    def fake_wall(fn, device, warmup=1, iters=3):
        return float(next(walls)), fn()

    monkeypatch.setattr(C, "time_wall", fake_wall)
    lines = []
    samples = C.collect_samples([500], "cpu", out=lines.append, repeats=3)
    per_pass = len(lines) // 3
    assert len(lines) == 3 * per_pass
    one = dict(zip((ln.split(",")[0] for ln in lines),
                   ([] for _ in lines)))
    for i, ln in enumerate(lines):
        one[ln.split(",")[0]].append(i + 1)
    for name, pairs in samples.items():
        if name.startswith("_"):
            continue
        want = float(np.median(one[f"calibrate/{name}_local_v500"]))
        assert [t for t, _ in pairs] == [want], name
        # the passes are one sweep apart
        assert one[f"calibrate/{name}_local_v500"] == [
            want - per_pass, want, want + per_pass]
    assert len(samples["_count_times"]) == 4
    assert sorted(samples["_count_times"]) == sorted(
        float(np.median(v)) for k, v in one.items()
        if k.endswith("_count_v500"))
    assert len(samples["_superstep_times"]) == 4
    for vt in samples["_superstep_times"]:
        assert set(vt) == set(C.SUPERSTEP_VARIANTS)
