"""The port's logical-axis layer against the JAX package's, bit for bit.

``rules_for`` and ``specs_from_defs(model_defs(cfg), rules, mesh)`` for
every config of ``configs/archs.py`` × every entry of ``SHAPES`` × the
16×16 ("data", "model") and 2×16×16 ("pod", "data", "model") meshes,
held by the stand-in the reference's own tests use (``axis_names`` and
``devices.shape``, ``tests/test_layout_knobs.py``), so that no 256 or 512
ranks are needed; each spec equals the reference's ``PartitionSpec`` read
as a tuple. The same for ``batch_logical_axes``, ``cache_logical_axes``,
``decode_state_logical_axes``, ``ShardingRules.with_overrides`` (``light``
sticky), ``shard_act``'s light mode, ``bubble_fraction`` and the mesh
helpers. Then the DTensor placements of every pruned spec on a 2×2 mesh
(a fake process group of 4 ranks in this one process): the local shard
shape DTensor computes equals the global shape divided as the spec says.
"""
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as REF_SHAPES
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.configs import get_config as ref_get_config
from repro.models import attention as RA
from repro.models import inputs as RI
from repro.models import transformer as RTF
from repro.parallel import layouts as RL
from repro.parallel import sharding as RSH
from repro.parallel.pipeline import bubble_fraction as ref_bubble
from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_configs
from repro_torch.launch import mesh as MESH
from repro_torch.models import attention as A
from repro_torch.models import inputs as I
from repro_torch.models import transformer as TF
from repro_torch.parallel import layouts as L
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.pipeline import bubble_fraction

ARCHS = list_configs()
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _stand_in(name):
    axes, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _tuples(tree):
    """A reference tree of PartitionSpecs as a tree of plain tuples."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_param_specs_equal_the_reference(arch, mesh_name):
    mesh = _stand_in(mesh_name)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert sorted(SHAPES) == sorted(REF_SHAPES)
    for name in SHAPES:
        rules = L.rules_for(cfg, SHAPES[name], mesh)
        rrules = RL.rules_for(rcfg, REF_SHAPES[name], mesh)
        assert rules.mapping == rrules.mapping and rules.light == rrules.light
        specs = SH.specs_from_defs(TF.model_defs(cfg), rules, mesh)
        rspecs = _tuples(RSH.specs_from_defs(RTF.model_defs(rcfg), rrules,
                                             mesh))
        assert specs == rspecs, name
        assert TF.param_specs(cfg, rules) == _tuples(
            RTF.param_specs(rcfg, rrules)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_state_logical_axes_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        assert I.batch_logical_axes(cfg, shape) == \
            RI.batch_logical_axes(rcfg, rshape), name
        specs, rspecs = I.input_specs(cfg, shape), RI.input_specs(rcfg,
                                                                  rshape)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in specs.items()} \
            == {k: (tuple(v.shape), f"torch.{v.dtype}")
                for k, v in rspecs.items()}, name
        assert all(v.device.type == "meta" for v in specs.values())
    state = TF.init_decode_state(cfg, 2, 16, device="meta")
    rstate = jax.eval_shape(lambda: RTF.init_decode_state(rcfg, 2, 16))
    assert TF.decode_state_logical_axes(cfg, state) == \
        RTF.decode_state_logical_axes(rcfg, rstate)
    assert A.cache_logical_axes() == RA.cache_logical_axes()


def test_rules_overrides_and_light_stickiness():
    r = SH.ShardingRules().with_overrides(light=True, seq=None)
    rr = RSH.ShardingRules().with_overrides(light=True, seq=None)
    assert r.light and r.mapping == rr.mapping
    r2, rr2 = r.with_overrides(act_ffn=None), rr.with_overrides(act_ffn=None)
    assert r2.light and rr2.light and r2.mapping == rr2.mapping
    assert SH.DEFAULT_RULES == RSH.DEFAULT_RULES
    assert SH.ShardingRules().mapping["kv_batch"] == ("pod", "data")
    logical = ("batch", None, "heads", "kv_seq")
    assert r.spec(logical) == tuple(rr.spec(logical))
    with pytest.raises(KeyError):
        r.axis("no_such_axis")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_pruning_and_named_shardings_equal_the_reference(mesh_name):
    mesh = _stand_in(mesh_name)
    rules = SH.ShardingRules()
    cases = [((256, 24, 128), ("batch", "heads", None)),
             ((64, 4096), ("fsdp", "vocab")),
             ((8, 3), ("batch", "seq")),
             ((512, 512), ("fsdp", "fsdp")),
             ((48, 16, 2), ("kv_batch", "kv_seq", "experts"))]
    for shape, logical in cases:
        spec = rules.spec(logical)
        ref = RSH._prune_spec_for(shape, RSH.ShardingRules().spec(logical),
                                  mesh)
        assert SH._prune_spec_for(shape, spec, mesh) == tuple(ref)
        assert SH.named_sharding(mesh, rules, logical, shape).spec == \
            tuple(ref)
    assert MESH.mesh_shape_dict(mesh) == dict(zip(*MESHES[mesh_name]))
    assert MESH.chips(mesh) == int(np.prod(MESHES[mesh_name][1]))


def test_shard_act_is_a_no_op_without_a_mesh_and_in_light_mode():
    x = torch.ones(4, 8, 16)
    assert SH.shard_act(x, ("batch", "seq", "embed")) is x
    with SH.use_mesh(_stand_in("16x16"), SH.ShardingRules(light=True)):
        # a plain tensor is a step's local shard: nothing to lay out
        assert SH.shard_act(x, ("batch", "seq", "embed"),
                            essential=True) is x
        assert SH.current_rules().light
    assert SH.current_mesh() is None and SH.current_rules() is None


def test_bubble_fraction():
    for s, m in [(4, 8), (1, 8), (2, 30), (8, 1)]:
        assert bubble_fraction(s, m) == ref_bubble(s, m)


def test_a_spec_that_dtensor_cannot_express_raises():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh's order"):
        SH.placements_for((("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="no axis 'pod'"):
        SH.placements_for((("pod", "data"),),
                          types.SimpleNamespace(mesh_dim_names=("data",)))


def test_meshes_refuse_another_world_size():
    with pytest.raises(ValueError, match="4 ranks"):
        MESH.make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="256 ranks.*fake world"):
        MESH.make_production_mesh(device="cpu")
    assert not dist.is_initialized()


@pytest.fixture
def fake_2x2():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                                "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_give_the_pruned_local_shapes(arch, fake_2x2):
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = fake_2x2
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cfg = get_config(arch)
    for shape in SHAPES.values():
        rules = L.rules_for(cfg, shape, mesh)
        shardings = SH.shardings_from_defs(TF.model_defs(cfg), rules, mesh)
        defs = TF.model_defs(cfg)

        def check(d, s):
            want = tuple(
                n // int(np.prod([sizes[a] for a in (
                    e if isinstance(e, tuple) else (e,))]))
                if e is not None else n
                for n, e in zip(d.shape, s.spec + (None,) * len(d.shape)))
            got, _ = compute_local_shape_and_global_offset(
                d.shape, mesh, s.placements)
            assert tuple(got) == want, (arch, shape.name, d.shape, s.spec)

        _walk(defs, shardings, check)


def _walk(defs, shardings, fn):
    if isinstance(defs, SH.PDef):
        fn(defs, shardings)
        return
    for k in defs:
        _walk(defs[k], shardings[k], fn)


# ---------------------------------------------------------------------------
# The model-parallel roles (transformer.model_roles) against the specs
# ---------------------------------------------------------------------------

# a leaf's logical axis that a model split takes, and the activation axis
# the rules must put on "model" for a block to compute its chunk
_SPLIT_AXES = {"heads": "act_heads", "kv_heads": "act_kv_heads",
               "ffn": "act_ffn", "expert_ffn": "act_ffn",
               "vocab": "act_vocab", "ssm_heads": "ssm_heads",
               "ssm_inner": "ssm_inner", "rwkv_heads": "rwkv_heads"}
# Mamba2's leaves whose "ssm_inner" dim is not whole heads
_NOT_HEADS = ("in_proj", "conv_w", "conv_b")


# the top-level keys whose leaves compute on each residual stream
_MAIN_KEYS = ("layers", "groups", "tail", "shared_attn", "final_norm",
              "embedding")
_ENCODER_KEYS = ("encoder", "enc_norm", "frontend")
# the blocks whose reference shard_act points name "seq_inner"
_INNER_BLOCKS = ("attn", "xattn", "mlp", "tm", "mamba")
_NORM_KEYS = ("ln1", "ln2", "ln_x", "ln", "final_norm", "enc_norm")


def _claims(gshape, logical, rules, mesh) -> bool:
    """Whether the reference's ``_prune_spec_for`` of ``logical`` (batch,
    sequence, ...) for a stream of global ``gshape`` keeps "model" on the
    sequence."""
    if not hasattr(mesh, "axis_names"):  # a DeviceMesh: its stand-in
        mesh = types.SimpleNamespace(axis_names=tuple(mesh.mesh_dim_names),
                                     devices=np.empty(tuple(mesh.shape)))
    entry = RSH._prune_spec_for(tuple(gshape[:len(logical)]),
                                rules.spec(logical), mesh)[1]
    return "model" in (entry if isinstance(entry, tuple) else (entry,))


def _stream_keys(cfg, shape, rules, mesh, m):
    """(the top-level keys of a split stream, those of a stream whose
    blocks keep its sequence inside too): a train or prefill step's
    streams, each by the reference's pruning of ``("batch", "seq",
    "embed")`` and, for a prefill, of ``("batch", "seq_inner")``, whose
    first use of "model" leaves the heads, ffn and vocab whole."""
    split, inner = set(), set()
    if m == 1:
        return split, inner
    streams = _seq_streams(cfg, shape)
    main = _MAIN_KEYS + (("frontend",) if cfg.frontend == "vision" else ())
    for name, gshape in streams.items():
        keys = main if name == "main" else _ENCODER_KEYS
        if _claims(gshape, ("batch", "seq", "embed"), rules, mesh):
            split.update(keys)
        if shape.kind == "prefill" and _claims(
                gshape, ("batch", "seq_inner"), rules, mesh):
            inner.update(keys)
    return split, inner


def _expected_roles(cfg, rules, specs, defs, m, split=(), inner=()):
    """Leaf by leaf, from the pruned specs: a leaf keeps its model chunk
    where its spec puts "model" on a split axis whose activation axis the
    rules put on "model" too, and the chunk is whole heads (RWKV's and
    Mamba2's heads divide by the model size; Mamba2's z|x|B|C|dt leaves
    never), KV heads only with the query heads; in a block under a key of
    ``inner`` whose activations name ``seq_inner`` (attention, the MLP,
    RWKV, Mamba2, the head's leaf), "model" went to the sequence first,
    and none keeps it. Then a leaf is partial where its block is split and
    the rank uses it whole: unsplit K/V of split attention, RWKV's mixes
    and decay, Mamba2's projection and conv; and, under a key of
    ``split`` (a stream split along its sequence), every norm scale, the
    frontend's projection, and where the block is split MoE's router and
    RWKV's ``mu_c`` and ``c_r``."""
    head = "embed" if cfg.tie_embeddings else "unembed"

    def keeps(path, d, spec):
        name = path[-1]
        if m == 1 or name in _NOT_HEADS:
            return False
        if path[0] in inner and (path[-2] in _INNER_BLOCKS
                                 or path == ("embedding", head)):
            return False
        for ax, entry in zip(d.axes, spec + (None,) * len(d.axes)):
            act = _SPLIT_AXES.get(ax)
            on = entry == "model" or (isinstance(entry, tuple)
                                      and "model" in entry)
            if act and on and "model" in str(rules.axis(act)):
                if ax == "rwkv_heads" and cfg.rwkv_heads % m:
                    return False
                if ax in ("ssm_heads", "ssm_inner") and cfg.ssm_heads % m:
                    return False
                return True
        return False

    flat_d = dict(_flat(defs))
    flat_s = dict(_flat(specs))
    kept = {p for p in flat_d if keeps(p, flat_d[p], flat_s[p])}
    # a block's leaves split together: K/V only with the query heads,
    # Mamba2's heads only with its ssm_inner rows
    for p in list(kept):
        if p[-1] in ("wk", "wv", "bk", "bv") and p[:-1] + ("wq",) not in kept:
            kept.discard(p)
    out = {}
    for p in flat_d:
        blk, name = p[:-1], p[-1]
        role = SH.KEEP if p in kept else None
        if role is None and (
                (name in ("wk", "wv", "bk", "bv") and blk + ("wq",) in kept)
                or (name in ("mu", "decay_base", "decay_A", "decay_B")
                    and blk + ("w_r",) in kept)
                or (name in _NOT_HEADS and blk + ("A_log",) in kept)):
            role = SH.PARTIAL
        if p[0] in split and (
                (name == "scale" and blk[-1] in _NORM_KEYS)
                or (p[0] == "frontend" and name == "proj")
                or (name == "router" and blk + ("w_up",) in kept)
                or (name in ("mu_c", "c_r") and blk + ("c_k",) in kept)):
            role = SH.PARTIAL
        out[p] = role
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _split_shape(d, spec, role, m):
    """The shape a block computes with: the model chunk where the leaf
    keeps it, else the whole."""
    if role != SH.KEEP:
        return d.shape
    return tuple(n // m if (e == "model" or (isinstance(e, tuple)
                                             and "model" in e)) else n
                 for n, e in zip(d.shape, spec + (None,) * len(d.shape)))


@pytest.mark.parametrize("mesh_name", ["2x2", "16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_roles_follow_the_pruned_specs(arch, mesh_name, fake_2x2):
    """Which leaves keep a model chunk (and compute on it), and which
    sum a partial gradient over "model", for every arch and train and
    prefill shape on a (2, 2) DeviceMesh of the fake process group and on
    the 16×16 stand-in, given the step's shape: a stream split along its
    sequence, and a prefill's ``seq_inner`` claiming "model" before the
    heads, ffn and vocab (llama3.2-3b's 24 heads on 16 model ranks at
    ``prefill_32k``: its attention, MLP and tied head whole); on the
    (2, 2) mesh the gather layout of a kept leaf (``keep_chunk``) gives
    it that chunk's local shape."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = fake_2x2 if mesh_name == "2x2" else _stand_in("16x16")
    m = 2 if mesh_name == "2x2" else 16
    cfg = get_config(arch)
    defs = TF.model_defs(cfg)
    for shape in SHAPES.values():
        if shape.kind == "decode":
            continue
        rules = L.rules_for(cfg, shape, mesh)
        specs = SH.specs_from_defs(defs, rules, mesh)
        got = dict(_flat(TF.model_roles(cfg, rules, mesh, shape)))
        want = _expected_roles(cfg, rules, specs, defs, m,
                               *_stream_keys(cfg, shape, rules, mesh, m))
        assert got == want, (arch, shape.name, {
            p: (got[p], want[p]) for p in want if got[p] != want[p]})
        if mesh_name != "2x2":
            continue
        shardings = dict(_flat(SH.shardings_from_defs(defs, rules, mesh)))
        for p, d in _flat(defs):
            spec = shardings[p].spec
            pl = shardings[p].placements
            # the layout the unit gathers the leaf by: the mesh dims that
            # shard it there are gathered, the others keep their chunk
            by = SH.keep_chunk(pl, 1) if got[p] == SH.KEEP else pl
            rep = SH.placements_for((), mesh)
            kept = tuple(a if a != b else rep[k]
                         for k, (a, b) in enumerate(zip(pl, by)))
            local, _ = compute_local_shape_and_global_offset(
                d.shape, mesh, kept)
            assert tuple(local) == _split_shape(d, spec, got[p], m), (
                arch, shape.name, p, spec)


SEQ_MESHES = {"2x2": (("data", "model"), (2, 2)), **MESHES}


def _seq_streams(cfg, shape, patches=None, frames=None):
    """The global (batch, length, width) of each residual stream a train
    or prefill step of ``shape`` runs: the tokens (with a vision config's
    patches in front, ``patches`` of them if given) and an enc-dec
    config's frames (``frames`` of them if given)."""
    st = I.batch_structure(cfg, shape)
    b, d = shape.global_batch, cfg.d_model
    p = (st["patches"][0][1] if patches is None else patches) \
        if "patches" in st else 0
    out = {"main": (b, st["tokens"][0][1] + p, d)}
    if "frames" in st:
        out["encoder"] = (b, st["frames"][0][1] if frames is None
                          else frames, d)
    return out


@pytest.mark.parametrize("mesh_name", sorted(SEQ_MESHES))
@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "seamless-m4t-medium", "llama3.2-3b"])
def test_the_sequence_split_follows_the_reference_pruning(arch, mesh_name):
    """The port's per-activation decision to split a residual stream's
    sequence over "model" (``sharding.seq_split_for``, Megatron-SP) is the
    reference's: "model" kept on the sequence by its ``_prune_spec_for``
    of the rules' ``("batch", "seq", "embed")`` spec for the stream's own
    global shape. Over every train and prefill shape and odd lengths: a
    VLM's patches and tokens as one sequence (P + S, with P that makes it
    odd), an enc-dec encoder's frames of their own length (T odd beside
    S even), and odd token counts. ``model_roles`` with the step's shape
    makes the stream's norm scales ``PARTIAL`` exactly where it splits."""
    axes, dims = SEQ_MESHES[mesh_name]
    mesh = types.SimpleNamespace(axis_names=axes, devices=np.empty(dims))
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    m = dict(zip(axes, dims))["model"]
    cases = []
    for name, shape in SHAPES.items():
        if shape.kind == "decode":
            continue
        cases.append((shape, {}))
        for odd in (1, 3, m + 1):
            cases.append((shape, {"patches": odd, "frames": odd}))
        odd_seq = ShapeSpec(shape.name, shape.kind, shape.seq_len + 1,
                            shape.global_batch)
        cases.append((odd_seq, {}))
    seen = set()
    for shape, over in cases:
        rules = L.rules_for(cfg, shape, mesh)
        rshape = RShapeSpec(shape.name, shape.kind, shape.seq_len,
                            shape.global_batch)
        rrules = RL.rules_for(rcfg, rshape, mesh)
        streams = _seq_streams(cfg, shape, **over)
        for stream, gshape in streams.items():
            want = RSH._prune_spec_for(gshape, rrules.spec(
                ("batch", "seq", "embed")), mesh)[1]
            want = "model" in (want if isinstance(want, tuple)
                               else (want,)) and m > 1
            got = SH.seq_split_for(gshape, rules, mesh)
            assert got == want, (shape.name, stream, gshape)
            seen.add((stream, got))
        if not over:  # the step's own stream shapes
            roles = TF.model_roles(cfg, rules, mesh, shape)
            main = SH.seq_split_for(streams["main"], rules, mesh)
            assert (roles["final_norm"]["scale"] == SH.PARTIAL) == main
            if "encoder" in streams:
                enc = SH.seq_split_for(streams["encoder"], rules, mesh)
                assert (roles["enc_norm"]["scale"] == SH.PARTIAL) == enc
    # both decisions met on every stream
    assert {got for _, got in seen} == {True, False}, seen


def test_llama_on_16_model_ranks_replicates_attention():
    """24 query heads do not split over 16 model ranks: every attention
    leaf of llama3.2-3b stays whole (the spec pruning drops "model" from
    the heads). In training its ffn and vocab keep their 1/16 chunks; its
    prefill keeps the blocks' inner sequence on "model" (``seq_inner``,
    which the rules set there and which claims "model" first), so the MLP
    and the tied head are whole too, each rank computing its rows."""
    mesh = _stand_in("16x16")
    cfg = get_config("llama3.2-3b")
    for shape in SHAPES.values():
        if shape.kind == "decode":
            continue
        rules = L.rules_for(cfg, shape, mesh)
        roles = TF.model_roles(cfg, rules, mesh, shape)
        layer = roles["layers"]
        prefill = shape.kind == "prefill"
        assert SH.seq_inner_for((shape.global_batch, shape.seq_len,
                                 cfg.d_model), rules, mesh) == prefill
        assert set(layer["attn"].values()) == {None}, shape.name
        assert set(layer["mlp"].values()) == {None if prefill else SH.KEEP}
        assert roles["embedding"] == {"embed": None if prefill
                                      else SH.KEEP}, shape.name


@pytest.mark.parametrize("mesh_name", sorted(SEQ_MESHES))
@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "seamless-m4t-medium", "llama3.2-3b"])
def test_seq_inner_follows_the_reference_pruning(arch, mesh_name):
    """Whether a prefill's blocks keep a stream's sequence on "model"
    inside (``sharding.seq_inner_for``) is the reference's
    ``_prune_spec_for`` of ``("batch", "seq_inner")`` for the stream's own
    global shape, under ``rules_for``'s rules and with the genome's
    override ``seq_inner="model"``, over every prefill shape and odd
    lengths (a VLM's patches, an enc-dec encoder's frames); and
    ``model_roles`` then keeps no chunk of the main stream's attention
    and MLP. A train step ignores it."""
    axes, dims = SEQ_MESHES[mesh_name]
    mesh = types.SimpleNamespace(axis_names=axes, devices=np.empty(dims))
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    seen = set()
    for shape in SHAPES.values():
        if shape.kind == "decode":
            continue
        for over in ({}, {"seq_inner": "model"}):
            rules = L.rules_for(cfg, shape, mesh, over)
            rrules = RL.rules_for(rcfg, RShapeSpec(
                shape.name, shape.kind, shape.seq_len, shape.global_batch),
                mesh, over)
            for odd in (None, 3):
                streams = _seq_streams(cfg, shape, patches=odd, frames=odd)
                for stream, gshape in streams.items():
                    want = _claims(gshape, ("batch", "seq_inner"), rrules,
                                   mesh) and dict(zip(axes, dims))[
                                       "model"] > 1
                    got = SH.seq_inner_for(gshape, rules, mesh)
                    assert got == want, (shape.name, over, stream, gshape)
                    seen.add(got)
            roles = TF.model_roles(cfg, rules, mesh, shape)
            inner = shape.kind == "prefill" and SH.seq_inner_for(
                _seq_streams(cfg, shape)["main"], rules, mesh)
            kept = {v for k in ("attn", "mlp") if k in roles["layers"]
                    for v in roles["layers"][k].values()}
            assert (SH.KEEP not in kept) or not inner, (shape.name, over)
    assert seen == {True, False}, seen


def test_seq_inner_without_the_stream_split_raises():
    """``seq_inner`` on "model" where the residual stream's ``seq`` is not
    (a layout the reference's ``rules_for`` never makes, only an override)
    raises, naming it; there is no fallback to the whole sequence."""
    mesh = _stand_in("16x16")
    cfg = get_config("llama3.2-3b")
    shape = SHAPES["prefill_32k"]
    rules = L.rules_for(cfg, shape, mesh, {"seq": None})
    with pytest.raises(ValueError, match="seq_inner on 'model'.*rules_for"):
        TF.model_roles(cfg, rules, mesh, shape)
    with pytest.raises(ValueError, match="seq_inner on 'model'"):
        SH.seq_inner_for((shape.global_batch, shape.seq_len, cfg.d_model),
                         rules, mesh)


def test_a_query_head_block_that_reads_no_whole_kv_block_raises():
    """Where the KV heads stay whole and a rank's query heads straddle
    them unevenly (12 heads over 4 KV heads on 3 model ranks), the split
    raises, naming the heads and the model size; MQA serves every rank
    from its one KV head."""
    from repro_torch.models.attention import kv_block

    with pytest.raises(ValueError, match="12 query heads over 4 KV heads"
                                         ".* 3 model"):
        kv_block(12, 4, 3, 1)
    assert [kv_block(8, 1, 4, r) for r in range(4)] == [(0, 1)] * 4
    assert [kv_block(32, 8, 16, r) for r in range(4)] == [
        (0, 1), (0, 1), (1, 1), (1, 1)]


@pytest.mark.parametrize("mesh_name", ["2x2", "16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_roles_and_state_shapes(arch, mesh_name, fake_2x2):
    """The serve step's split under the decode rules, for every arch and
    decode shape on a (2, 2) DeviceMesh of the fake process group and on
    the 16×16 stand-in: attention's leaves whole (the rules' ``act_heads``
    None), the ffn, the vocab, the experts' ffn and the RWKV and SSM heads
    keeping their chunk where the pruned specs split them (the same rule
    as train and prefill); every state leaf's local shape the pruned
    spec's (on the fake mesh, as DTensor computes it), and the layout
    ``serve_layout`` takes: the caches' sequence over "model", or over
    "data" and "model" at batch 1, and the batch as the tokens'."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.launch import steps as S

    mesh = fake_2x2 if mesh_name == "2x2" else _stand_in("16x16")
    m = 2 if mesh_name == "2x2" else 16
    sizes = {"data": m, "model": m}
    cfg = get_config(arch)
    defs = TF.model_defs(cfg)
    for shape in SHAPES.values():
        if shape.kind != "decode":
            continue
        rules = L.rules_for(cfg, shape, mesh)
        specs = SH.specs_from_defs(defs, rules, mesh)
        got = dict(_flat(TF.model_roles(cfg, rules, mesh)))
        assert got == _expected_roles(cfg, rules, specs, defs, m), (
            arch, shape.name)
        assert not [p for p, r in got.items()
                    if set(p) & {"attn", "xattn"} and r is not None]
        kept = {p[-2] for p, r in got.items() if r == SH.KEEP}
        blocks = {p[-2] for p in got} & {"mlp", "moe", "tm", "mamba",
                                         "embedding"}
        if mesh_name == "2x2":  # every split block splits on 2 ranks
            assert kept == blocks, (arch, shape.name, kept, blocks)
        layout = S.serve_layout(cfg, shape, rules, mesh)
        has_cache = cfg.family != "ssm"
        assert layout.kv_seq == ((("data", "model") if shape.global_batch
                                  == 1 else ("model",)) if has_cache
                                 else ()), (arch, shape.name, layout)
        assert layout.batch == (() if shape.global_batch == 1
                                else ("data",)), (arch, shape.name, layout)
        state = TF.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                     device="meta")
        shardings = S._state_shardings(cfg, state, rules, mesh)
        for (path, t), (_, sh) in zip(_flat(state), _flat(shardings)):
            spec = tuple(sh.spec) + (None,) * (t.dim() - len(sh.spec))
            want = tuple(n // int(np.prod([sizes[a] for a in (
                e if isinstance(e, tuple) else (e,))])) if e else n
                for n, e in zip(t.shape, spec))
            block = {"wkv": ("layers", "tm", "w_r"),
                     "ssm": ("groups", "mamba", "A_log")}.get(path[-1])
            if block:  # this rank's heads where the blocks keep theirs
                split = got[block] == SH.KEEP
                assert want[2] == t.shape[2] // (m if split else 1), (
                    arch, shape.name, path)
            if mesh_name != "2x2":
                continue
            local, _ = compute_local_shape_and_global_offset(
                tuple(t.shape), mesh, sh.placements)
            assert tuple(local) == want, (arch, shape.name, path, spec)
