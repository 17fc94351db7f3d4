"""The reference and the comparison that decides ``correct``, on the CPU at
smoke size: the reference against the program computing in float32 (the
two agree to rounding); the control (the reference in float8 products)
reading well above the program; and a run with each fault a cell can have
planted under its timed path coming out not correct.  The chip test runs
the control at the cell's own size (``cuda``)."""
import time

import pytest
import torch

from bench import faults, harness, ppo, spec
from test_portbench_runs import SMOKE

import control

BENCH = spec.load_benchmark()
SEED = 2**31 + 99


@pytest.fixture(autouse=True)
def one_thread():
    """Small ops on many threads crawl beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell(name):
    return spec.find_cell(BENCH, name)


def run(name, f32=False, **kw):
    model, mix = SMOKE[name]
    if f32:
        model = dict(model, compute_dtype="float32")
    return harness.run_cell(BENCH, cell(name), SEED, 0.5, 0, "cpu",
                            time.perf_counter(), model_overrides=model,
                            mix_overrides=mix, **kw)


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_reference_agrees_with_the_program_in_float32(name):
    res = run(name, f32=True)
    assert res["correct"]
    for key, c in res["checks"].items():
        assert c["value"] <= (0 if key in ("env_mismatches", "short_requests")
                              else 1e-3), key


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_control_reads_well_above_the_program(name):
    model, mix = SMOKE[name]
    got = control.readings(BENCH, cell(name), SEED, ["sound", "control"], 0.5,
                           "cpu", model_overrides=model, mix_overrides=mix)
    key = "logp_gap" if "logp_gap" in got["sound"] else "served_gap_rms"
    assert got["control"][key] > 3 * got["sound"][key]


def test_the_window_ends_the_run_with_the_queue_waiting():
    from bench import batchgen
    model, mix = SMOKE["zamba2-7b.batchgen"]
    ctx = harness.context(BENCH, cell("zamba2-7b.batchgen"), SEED, 0.5,
                          False, "cpu", time.perf_counter(),
                          model_overrides=model,
                          mix_overrides=dict(mix, queue_per_s=400))
    _, _, engine, reqs = batchgen.build(ctx)
    win = batchgen.serve(ctx, engine, reqs)
    assert win.t_end - win.t0 >= 0.5 and win.blocks > 0
    done = batchgen.finished(reqs)
    assert 0 < len(done) < len(reqs)
    assert all(len(r.tokens) == r.max_tokens for r in done)
    # the engine has its own methods back, and the window lets go of it
    assert "_run_block" not in vars(engine) or \
        vars(engine)["_run_block"].__self__ is engine
    assert win.engine is None


@pytest.mark.parametrize("fault", faults.TRAIN_FAULTS)
def test_a_training_fault_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(ppo, "program_pieces",
                        faults.ppo_pieces(ppo.program_pieces, fault))
    res = run("mamba2-1.3b.ppo")
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_a_served_token_altered_is_not_correct(monkeypatch):
    from bench import batchgen
    build = batchgen.build

    def built(ctx):
        cfg, weights, engine, reqs = build(ctx)
        faults.serve_token(engine)
        return cfg, weights, engine, reqs

    monkeypatch.setattr(batchgen, "build", built)
    res = run("zamba2-7b.batchgen")
    assert res["correct"] is False
    assert res["checks"]["served_gap_rms"]["value"] > \
        res["checks"]["served_gap_rms"]["limit"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
def test_control_fails_the_limits_at_the_cell_size(card, name):
    got = control.readings(BENCH, cell(name), 3400000001,
                           ["sound", "control"], 45, card)
    from reference import compare
    limits = compare.load_limits(name)
    strip = {k: v for k, v in got["control"].items() if k != "diag"}
    assert compare.judge(strip, limits)[0] is False
    sound = {k: v for k, v in got["sound"].items() if k != "diag"}
    assert compare.judge(sound, limits)[0] is True
