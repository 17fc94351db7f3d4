"""The benchmark's files on the CPU: cells, configurations, mixes, readers
and limits found from ``BENCHMARK.json``; the traffic generator's
determinism; the frozen arithmetic against values worked by hand."""
import json
import math

import numpy as np
import pytest
import torch

from bench import arith, spec, traffic, weights
from reference import compare

BENCH = spec.load_benchmark()


def test_every_cell_finds_its_files():
    for cell in BENCH["workloads"]:
        assert spec.find_cell(BENCH, cell["name"]) is cell
        cfg = spec.load_config(BENCH, cell["config"])
        assert cfg["name"] == cell["config"]
        assert cfg["reduced"] == spec.config_entry(
            BENCH, cell["config"])["reduced"]
        mix = spec.load_traffic(cell["traffic"])
        assert mix["kind"] in ("lm_ppo", "batch_generation")
        limits = compare.load_limits(cell["name"])
        assert all(math.isfinite(v) and v >= 0 for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.load_reader(metric))


def test_metrics_for_a_cell():
    e2e = {m["name"] for m in spec.metrics_for(BENCH, "mamba2-1.3b.ppo",
                                               False)}
    assert e2e == {"ppo_samples_per_s", "setup_s"}
    layer = {m["name"] for m in spec.metrics_for(BENCH, "zamba2-7b.batchgen",
                                                 True)}
    assert "admit_ms.gen" in layer and "rollout_s.ppo" not in layer
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            have = {x["name"] for x in spec.metrics_for(BENCH, cell, False)}
            assert m["moves"] in have


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.find_cell(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no_such_metric")


def test_config_files_keep_the_catalog_keys_and_reduce_nothing():
    for entry in BENCH["configs"]:
        cfg = spec.load_config(BENCH, entry["name"])
        assert entry["reduced"] == [] and cfg["reduced"] == []
        assert cfg["source"] == entry["source"]
        assert cfg["model"]["name"] == entry["name"]


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 3300000101])
def test_traffic_is_a_function_of_the_seed(seed):
    mix = spec.load_traffic("batchgen")
    a = traffic.make_requests(mix, 45, seed, 32000)
    b = traffic.make_requests(mix, 45, seed, 32000)
    assert [(r.max_tokens, r.prompt.tolist()) for r in a] == \
        [(r.max_tokens, r.prompt.tolist()) for r in b]
    other = traffic.make_requests(mix, 45, seed + 1, 32000)
    # every seed queues the same sizes in the same order; only tokens move
    assert [(r.max_tokens, len(r.prompt)) for r in a] == \
        [(r.max_tokens, len(r.prompt)) for r in other]
    assert any(not np.array_equal(r.prompt, o.prompt)
               for r, o in zip(a, other))
    assert len(a) == mix["slots"] + 3 * 45
    lens = [r.max_tokens for r in a]
    assert 64 <= min(lens) < 70 and 500 < max(lens) <= 512
    plens = [len(r.prompt) for r in a]
    assert min(plens) >= 16 and max(plens) <= 64


def test_traffic_sizes_by_hand():
    assert traffic.size_at({"dist": "uniform", "lo": 16, "hi": 64}, 0.5) \
        == 40
    log = {"dist": "log_uniform", "lo": 64, "hi": 512}
    assert [traffic.size_at(log, q) for q in (0, 1 / 3, 2 / 3)] == \
        [64, 128, 256]
    # the R2 sequence's first two: quantiles 0.5 / 0.5, then
    # 0.5 + 0.5698 (prompt) and 0.5 + 0.7549 (output), modulo 1
    mix = {"prompt_len": {"dist": "uniform", "lo": 0, "hi": 1000},
           "output_len": {"dist": "uniform", "lo": 0, "hi": 1000}}
    assert traffic.sizes(mix, 2) == [(500, 500), (70, 255)]


def test_ssd_arithmetic_by_hand():
    # one chunk of 2 rows, B1 H1 P1 G1 N1: pairs 3; C.B^T 2*3*1 = 6,
    # M.x 2*3*1 = 6, C.S and B^T.(x w) 4*2*1*1 = 8
    assert arith.ssd_flops(1, 2, 1, 1, 1, 1, 2) == 20
    # two chunks of 1 row each: pairs 1 a chunk: (2 + 2 + 4) x 2
    assert arith.ssd_flops(1, 2, 1, 1, 1, 1, 1) == 16
    # x and y bf16 (2 x 2 x 2), dt f32 (2 x 4), A (4), B and C bf16
    # (2 x 2 x 2), state f32 (4)
    assert arith.ssd_bytes(1, 2, 1, 1, 1, 1) == 8 + 8 + 4 + 8 + 4
    # the cell's shape: 103.8 MB against 13.04 GFLOP, bytes bound
    t, why = arith.bound_s(arith.ssd_bytes(16, 256, 64, 64, 1, 128),
                           arith.ssd_flops(16, 256, 64, 64, 1, 128, 256))
    assert why == "bytes" and t == pytest.approx(103_809_280 / 3.35e12)


def test_decode_attention_arithmetic_by_hand():
    # B2 H1 Hkv1 dh4 over 10 cached positions: q and out 2 * 2 * 2 * 4,
    # K and V 2 * 2 * 10 * 4, kv_len 4 * 2
    assert arith.decode_attn_bytes(2, 1, 1, 4, 10) == 32 + 160 + 8
    assert arith.decode_attn_flops(1, 4, 10) == 160
    t, why = arith.bound_s(1e9, 1e9)
    assert why == "bytes" and t == pytest.approx(1e9 / 3.35e12)


def test_parameter_count_matches_the_program():
    from repro_torch.models.config import ModelConfig
    for entry in BENCH["configs"]:
        fields = spec.load_config(BENCH, entry["name"])["model"]
        cfg = ModelConfig(**fields)
        assert arith.n_params(fields) == cfg.n_params()
        assert arith.n_active_params(fields) == cfg.n_active_params()


def test_token_parameters_count_the_shared_block_at_every_site():
    mamba = spec.load_config(BENCH, "mamba2-1.3b")["model"]
    assert arith.token_params(mamba) == arith.n_active_params(mamba)
    zamba = spec.load_config(BENCH, "zamba2-7b")["model"]
    # 81 // 6 = 13 sites; the count holds the block once: 12 more of
    # attention (q, k, v, o: 4 x 3584 x 32 x 112) and the MLP (3 x 3584 x
    # 14336)
    extra = 12 * (4 * 3584 * 32 * 112 + 3 * 3584 * 14336)
    assert extra == 2_466_250_752
    assert arith.token_params(zamba) - arith.n_active_params(zamba) == extra


def test_weight_scales_by_hand():
    mamba = spec.load_config(BENCH, "mamba2-1.3b")["model"]
    zamba = spec.load_config(BENCH, "zamba2-7b")["model"]
    assert weights.residual_writes(mamba) == 48
    assert weights.residual_writes(zamba) == 81 + 2 * 13
    assert weights.matrix_scale("layers.0.ssd.out_proj", (64, 64, 2048),
                                48) == pytest.approx(1 / math.sqrt(4096 * 48))
    assert weights.matrix_scale("shared_attn.mlp.wd", (14336, 3584),
                                107) == pytest.approx(1 / math.sqrt(14336 * 107))
    assert weights.matrix_scale("layers.0.ssd.wx", (2048, 64, 64), 48) == \
        pytest.approx(1 / 2048 ** 0.5)
    assert weights.matrix_scale("tok_embed", (50304, 2048), 48) == 1.0


def test_weights_are_a_function_of_the_seed():
    model = dict(spec.load_config(BENCH, "mamba2-1.3b")["model"],
                 n_layers=2)
    shapes = {"tok_embed": ((8, 4), torch.float32),
              "layers.0.ssd.out_proj": ((2, 3, 4), torch.float32),
              "layers.0.ssd.A_log": ((4,), torch.float32),
              "layers.0.ssd.dt_bias": ((4,), torch.float32),
              "layers.0.norm.scale": ((4,), torch.float32)}
    a = weights.make_weights(shapes, model, 2**31 + 3, "cpu")
    b = weights.make_weights(shapes, model, 2**31 + 3, "cpu")
    c = weights.make_weights(shapes, model, 2**31 + 4, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in shapes)
    assert not torch.equal(a["tok_embed"], c["tok_embed"])
    assert torch.allclose(a["layers.0.ssd.A_log"].exp(),
                          torch.tensor([1.0, 6.0, 11.0, 16.0]))
    dt = torch.nn.functional.softplus(a["layers.0.ssd.dt_bias"])
    assert torch.allclose(dt, torch.tensor([1e-3, 10 ** (-7 / 3),
                                            10 ** (-5 / 3), 1e-1]),
                          rtol=1e-5)
    assert torch.equal(a["layers.0.norm.scale"], torch.ones(4))


def test_intervals_by_hand():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert arith.union_seconds(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert arith.union_seconds(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert arith.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def test_limits_are_json_numbers():
    for cell in BENCH["workloads"]:
        raw = json.loads((compare.LIMITS / f"{cell['name']}.json")
                         .read_text())
        assert raw and all(isinstance(v, (int, float)) for v in raw.values())
