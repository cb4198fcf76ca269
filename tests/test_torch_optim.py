"""The port's optimizers, schedules, gradient compression, data pipeline
and Checkpointer against the JAX package's, on the CPU.

Inputs are drawn with numpy and handed to both packages. Tolerances: f32
leaves within 1e-6 relative (of each element, plus 1e-6 of the leaf's max
|value| where an element is near 0: XLA and PyTorch may order or fuse the
same f32 operations differently), bf16 leaves within one bf16 ulp; int8
codes, batches and checkpoints bit for bit. The reference's own substrate
cases (``tests/test_substrate.py``) are run against the port as well.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.optim as RO
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs import smoke_shape as ref_smoke_shape
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLMStream as RefStream
from repro.optim import adafactor as RA
from repro_torch import optim as O
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced, smoke_shape
from repro_torch.data import DataConfig, SyntheticLMStream, device_put_batch
from repro_torch.models.weights import state_to_numpy
from repro_torch.optim import adafactor as A

STEPS = 3


def _draw(rng, shape, dtype):
    return (rng.standard_normal(shape) + 0.5).astype(np.float32).astype(dtype)


def _trees(seed):
    """Params (numpy), and STEPS gradient trees, f32 and bf16 leaves of
    rank 1 to 3."""
    rng = np.random.default_rng(seed)
    bf16 = ml_dtypes.bfloat16
    shapes = {"w": ((4, 8), np.float32), "b": ((8,), np.float32),
              "emb": ((16, 8), bf16), "stack": {"wq": ((2, 4, 8), bf16),
                                                "scale": ((2, 8), np.float32)},
              "norm": ((8,), bf16)}

    def build(spec, dtype_of=None):
        if isinstance(spec, dict):
            return {k: build(v, dtype_of) for k, v in spec.items()}
        shape, dt = spec
        return _draw(rng, shape, dtype_of or dt)

    params = build(shapes)
    grads = [build(shapes) for _ in range(STEPS)]
    return params, grads


def _to_port(tree):
    return jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a).view(np.int16)).view(torch.bfloat16)
        if np.asarray(a).dtype == ml_dtypes.bfloat16
        else torch.from_numpy(np.array(a)), tree)


def _to_numpy(tree):
    out = state_to_numpy(tree)
    return jax.tree.map(np.asarray, out)


def _close(port, ref):
    """Every leaf of the port's tree (numpy from ``state_to_numpy``) within
    the stated tolerance of the reference's."""
    flat_p = jax.tree.leaves(port)
    flat_r = jax.tree.leaves(jax.tree.map(np.asarray, ref))
    assert len(flat_p) == len(flat_r)
    for p, r in zip(flat_p, flat_r):
        if r.dtype == ml_dtypes.bfloat16:
            assert p.dtype == np.uint16
            pf = p.view(ml_dtypes.bfloat16).astype(np.float32)
            rf = r.astype(np.float32)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(rf),
                                                      1e-30))) - 7)
            assert np.all(np.abs(pf - rf) <= ulp), np.abs(pf - rf).max()
        elif r.dtype.kind == "f":
            assert p.dtype == r.dtype
            np.testing.assert_allclose(
                p, r, rtol=1e-6, atol=1e-6 * float(np.abs(r).max(initial=1.0)))
        else:
            np.testing.assert_array_equal(p, r)


# ---------------------------------------------------------------------------
# Optimizers and schedules: the same numbers over STEPS steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_adamw_matches_reference(seed):
    params, grads = _trees(seed)
    cfg = RO.AdamWConfig(lr=1e-2)
    rp = jax.tree.map(jnp.asarray, params)
    rs = RO.init_opt_state(rp)
    pp = _to_port(params)
    ps = O.init_opt_state(pp)
    for i, g in enumerate(grads):
        rp, rs, rm = RO.adamw_update(rp, jax.tree.map(jnp.asarray, g), rs,
                                     cfg, lr_scale=0.5 + i)
        pp2, ps2, pm = O.adamw_update(pp, _to_port(g), ps,
                                      O.AdamWConfig(lr=1e-2),
                                      lr_scale=0.5 + i)
        assert pp2 is pp and ps2 is ps  # in place
        _close(_to_numpy(pp), rp)
        _close(_to_numpy({"m": ps["m"], "v": ps["v"]}),
               {"m": rs["m"], "v": rs["v"]})
        assert int(ps["count"]) == int(rs["count"]) == i + 1
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        assert pm["lr"] == pytest.approx(float(rm["lr"]), rel=1e-7)


def test_adamw_decays_leaves_of_rank_two_and_more_only():
    params = {"v": torch.ones(4), "m": torch.ones(2, 2)}
    state = O.init_opt_state(params)
    zero = {"v": torch.zeros(4), "m": torch.zeros(2, 2)}
    O.adamw_update(params, zero, state, O.AdamWConfig(lr=0.5,
                                                      weight_decay=0.1))
    assert torch.equal(params["v"], torch.ones(4))
    assert torch.allclose(params["m"], torch.full((2, 2), 0.95))


def test_adamw_slices_a_large_leaf_without_changing_values(monkeypatch):
    params, grads = _trees(3)
    whole = _to_port(params)
    sliced = _to_port(params)
    s_whole, s_sliced = O.init_opt_state(whole), O.init_opt_state(sliced)
    from repro_torch.optim import adamw

    O.adamw_update(whole, _to_port(grads[0]), s_whole, O.AdamWConfig())
    monkeypatch.setattr(adamw, "SLICE_ELEMENTS", 8)
    O.adamw_update(sliced, _to_port(grads[0]), s_sliced, O.AdamWConfig())
    for a, b in zip(jax.tree.leaves(_to_numpy([whole, s_whole["m"]])),
                    jax.tree.leaves(_to_numpy([sliced, s_sliced["m"]]))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("decay", [0.0, 0.1])
def test_adafactor_matches_reference(decay):
    params, grads = _trees(2)
    rcfg = RA.AdafactorConfig(lr=1e-2, weight_decay=decay)
    pcfg = A.AdafactorConfig(lr=1e-2, weight_decay=decay)
    rp = jax.tree.map(jnp.asarray, params)
    rs = RA.init_factored_state(rp)
    pp = _to_port(params)
    ps = A.init_factored_state(pp)
    _close(_to_numpy(ps), rs)
    for g in grads:
        rp, rs, rm = RA.adafactor_update(rp, jax.tree.map(jnp.asarray, g),
                                         rs, rcfg)
        _, _, pm = A.adafactor_update(pp, _to_port(g), ps, pcfg)
        _close(_to_numpy(pp), rp)
        _close(_to_numpy(ps), rs)
        assert pm["lr"] == pytest.approx(float(rm["lr"]))


def test_schedules_match_reference():
    for step in (0, 1, 7, 50, 99, 100, 101, 777, 5000, 9999, 10_000,
                 20_000):
        for kw in ({}, {"warmup": 10, "total": 1000, "floor": 0.0}):
            np.testing.assert_allclose(
                float(O.warmup_cosine(step, **kw)),
                float(RO.warmup_cosine(step, **kw)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(O.rsqrt(step)),
                                   float(RO.rsqrt(step)), rtol=1e-6)
        np.testing.assert_allclose(float(O.rsqrt(step, warmup=3)),
                                   float(RO.rsqrt(step, warmup=3)), rtol=1e-6)


def test_grad_compression_matches_reference_bit_for_bit():
    rng = np.random.default_rng(4)
    grads = [{"a": (rng.standard_normal((8, 16)) * 10).astype(np.float32),
              "b": rng.standard_normal(33).astype(np.float32)}
             for _ in range(STEPS)]
    rres = RO.init_error_feedback(jax.tree.map(jnp.asarray, grads[0]))
    pres = O.init_error_feedback(_to_port(grads[0]))
    for g in grads:
        q, s = O.compress(torch.from_numpy(g["a"]))
        rq, rs = RO.compress(jnp.asarray(g["a"]))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert q.dtype == torch.int8 and float(s) == float(rs)
        np.testing.assert_array_equal(O.decompress(q, s).numpy(),
                                      np.asarray(RO.decompress(rq, rs)))
        rapprox, rres = RO.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), rres)
        papprox, pres = O.compress_with_feedback(_to_port(g), pres)
        for a, b in zip(jax.tree.leaves(_to_numpy([papprox, pres])),
                        jax.tree.leaves([rapprox, rres])):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert O.grad_compression.compression_ratio() == \
        RO.grad_compression.compression_ratio()


# -- the reference's substrate cases, against the port ----------------------


def test_adamw_converges_on_quadratic():
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((4, 8)).astype(
        np.float32) + 2.0), "b": torch.ones(8)}
    state = O.init_opt_state(params)
    cfg = O.AdamWConfig(lr=0.05, weight_decay=0.0)

    def loss(p):
        return torch.sum(torch.square(p["w"])) + torch.sum(
            torch.square(p["b"]))

    l0 = float(loss(params))
    for _ in range(200):
        O.adamw_update(params, {k: 2 * v for k, v in params.items()}, state,
                       cfg)
    assert float(loss(params)) < 0.01 * l0


def test_adamw_mixed_precision_dtypes():
    params = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
    state = O.init_opt_state(params)
    g = {"w": torch.full((8, 8), 0.1, dtype=torch.bfloat16)}
    p2, s2, metrics = O.adamw_update(params, g, state, O.AdamWConfig())
    assert p2["w"].dtype == torch.bfloat16
    assert s2["m"]["w"].dtype == torch.float32
    assert torch.isfinite(metrics["grad_norm"])


def test_adafactor_state_is_small_and_converges():
    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(rng.standard_normal((16, 8)).astype(
        np.float32) + 1.0)}
    state = A.init_factored_state(params)
    assert state["vr"]["w"].shape == (16,)
    assert state["vc"]["w"].shape == (8,)
    assert state["m"]["w"].dtype == torch.bfloat16
    l0 = float(torch.sum(torch.square(params["w"])))
    cfg = A.AdafactorConfig(lr=0.05)
    for _ in range(300):
        A.adafactor_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(torch.sum(torch.square(params["w"]))) < 0.05 * l0


def test_warmup_cosine_shape():
    assert float(O.warmup_cosine(0)) == 0.0
    assert float(O.warmup_cosine(100)) == pytest.approx(1.0)
    assert float(O.warmup_cosine(10_000)) == pytest.approx(0.1, abs=1e-3)


@pytest.mark.parametrize("seed", range(5))
def test_compress_roundtrip_bounded_error(seed):
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        64).astype(np.float32) * 10)
    q, s = O.compress(g)
    err = torch.max(torch.abs(O.decompress(q, s) - g))
    assert float(err) <= float(s) * 0.5 + 1e-6


def test_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(0)
    resid = O.init_error_feedback({"w": torch.zeros(32)})
    true_sum, approx_sum = torch.zeros(32), torch.zeros(32)
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.standard_normal(32).astype(
            np.float32))}
        approx, resid = O.compress_with_feedback(g, resid)
        true_sum += g["w"]
        approx_sum += approx["w"]
    np.testing.assert_allclose(approx_sum + resid["w"], true_sum, rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# Data: the same bytes, the same prefetch order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "llava-next-mistral-7b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("task", ["arithmetic", "uniform"])
def test_batches_are_byte_identical(arch, task):
    rcfg, cfg = ref_reduced(ref_get_config(arch)), reduced(get_config(arch))
    shape, rshape = smoke_shape("train"), ref_smoke_shape("train")
    for hosts, host in ((1, 0), (2, 0), (2, 1)):
        ref = RefStream(rcfg, rshape, RefDataConfig(
            seed=3, num_hosts=hosts, host_index=host, task=task))
        port = SyntheticLMStream(cfg, shape, DataConfig(
            seed=3, num_hosts=hosts, host_index=host, task=task))
        for step in (0, 1, 42):
            a, b = port.batch_at(step), ref.batch_at(step)
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (k, step)


def test_prefetch_order_and_restart_match_reference():
    rcfg, cfg = ref_reduced(ref_get_config("llama3.2-3b")), \
        reduced(get_config("llama3.2-3b"))
    for start in (0, 5):
        ref = RefStream(rcfg, ref_smoke_shape("train")).prefetching(start)
        port = SyntheticLMStream(cfg, smoke_shape("train")).prefetching(start)
        try:
            for i in range(4):
                (sa, a), (sb, b) = next(port), next(ref)
                assert sa == sb == start + i
                for k in a:
                    assert a[k].tobytes() == b[k].tobytes()
        finally:
            ref.close()
            port.close()


def test_data_determinism_and_restart():
    cfg = reduced(get_config("llama3.2-3b"))
    shape = smoke_shape("train")
    s1 = SyntheticLMStream(cfg, shape, DataConfig(seed=7))
    s2 = SyntheticLMStream(cfg, shape, DataConfig(seed=7))
    b1, b2 = s1.batch_at(42), s2.batch_at(42)
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    assert not np.array_equal(s1.batch_at(0)["tokens"],
                              s1.batch_at(1)["tokens"])


def test_data_host_sharding_disjoint():
    cfg = reduced(get_config("llama3.2-3b"))
    shape = smoke_shape("train")
    h0 = SyntheticLMStream(cfg, shape, DataConfig(seed=1, num_hosts=2,
                                                  host_index=0))
    h1 = SyntheticLMStream(cfg, shape, DataConfig(seed=1, num_hosts=2,
                                                  host_index=1))
    assert h0.local_batch == shape.global_batch // 2
    assert not np.array_equal(h0.batch_at(0)["tokens"],
                              h1.batch_at(0)["tokens"])


def test_data_labels_are_next_tokens():
    b = SyntheticLMStream(reduced(get_config("llama3.2-3b")),
                          smoke_shape("train")).batch_at(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_prefetch_iterator_and_device_put():
    stream = SyntheticLMStream(reduced(get_config("llama3.2-3b")),
                               smoke_shape("train"))
    it = stream.prefetching(start_step=5)
    step, batch = next(it)
    assert step == 5
    np.testing.assert_array_equal(batch["tokens"],
                                  stream.batch_at(5)["tokens"])
    it.close()
    on = device_put_batch(batch, "cpu")
    assert on["tokens"].dtype == torch.int32
    assert on["loss_mask"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Checkpointer: the reference's cases, and each package restoring the other's
# ---------------------------------------------------------------------------


def _port_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.linspace(-3, 3, 4).to(torch.bfloat16),
                       "list": [torch.ones(2, dtype=torch.int32)]},
            "step": torch.tensor(3, dtype=torch.int32)}


def _ref_tree():
    return {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "nested": {"b": jnp.linspace(-3, 3, 4).astype(jnp.bfloat16),
                       "list": [jnp.ones(2, jnp.int32)]},
            "step": jnp.asarray(3, jnp.int32)}


def _zeros_like(tree):
    return jax.tree.map(torch.zeros_like, tree)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    tree = _port_tree()
    for step in (1, 2, 3):
        ck.save(step, tree, blocking=True)
    assert ck.latest_step() == 3
    restored = ck.restore(3, _zeros_like(tree))
    assert torch.equal(restored["a"], tree["a"])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [2, 3]


def test_checkpoint_detects_shape_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones(2, 2)}, blocking=True)
    with pytest.raises(ValueError):
        ck.restore(1, {"a": torch.ones(3, 3)})


def test_checkpoint_detects_a_corrupt_manifest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones(2)}, blocking=True)
    path = tmp_path / "step_1" / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["leaves"]["a"]["shape"] = [3]
    path.write_text(json.dumps(manifest))
    with pytest.raises(IOError):
        ck.restore(1, {"a": torch.ones(2)})


def test_checkpoint_async_then_wait_and_snapshot_is_taken_at_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.ones(128, 128)}
    ck.save(7, tree)
    tree["a"].add_(1)  # in place after save returns: not in the checkpoint
    ck.wait()
    assert ck.latest_step() == 7
    assert torch.equal(ck.restore(7, {"a": torch.zeros(128, 128)})["a"],
                       torch.ones(128, 128))


def _files(path):
    with np.load(path / "arrays.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return json.loads((path / "manifest.json").read_text()), arrays


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A directory the reference wrote restores in the port and the port's
    in the reference, bit for bit (bf16 included), and both write the same
    manifest (digest included) and the same arrays."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    RefCheckpointer(str(ref_dir)).save(5, _ref_tree(), blocking=True,
                                       extra={"k": 1})
    Checkpointer(str(port_dir)).save(5, _port_tree(), blocking=True,
                                     extra={"k": 1})
    (rm, ra), (pm, pa) = _files(ref_dir / "step_5"), _files(port_dir /
                                                            "step_5")
    assert pm == rm
    assert list(pa) == list(ra)
    for k in ra:
        assert pa[k].dtype == ra[k].dtype and pa[k].tobytes() == \
            ra[k].tobytes(), k

    into_port = Checkpointer(str(ref_dir)).restore(
        5, _zeros_like(_port_tree()))
    for a, b in zip(jax.tree.leaves(into_port),
                    jax.tree.leaves(_port_tree())):
        assert a.dtype == b.dtype and torch.equal(a, b)
    into_ref = RefCheckpointer(str(port_dir)).restore(5, _ref_tree())
    for a, b in zip(jax.tree.leaves(into_ref), jax.tree.leaves(_ref_tree())):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
