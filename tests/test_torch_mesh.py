"""The port's mesh, partitioner and sharding rules against the JAX
package's, on the CPU without a process group: MeshConfig's sizes and
errors, the device (rank) order of plain and multislice meshes against
JAX's device arrays on the virtual CPU devices, and ``Partitioner.
spec_for`` for every parameter of a tiny GPT, a Llama-shaped MoE decoder
and a BERT MoE classifier over four meshes, identical to JAX's."""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.convert import flax_layout
from kubeflow_tpu_torch.models import bert as tb
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import partitioner as tpart
from kubeflow_tpu_torch.parallel import sharding as tshard

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

CONFIGS = [
    (dict(), 8), (dict(data=2, fsdp=4), 8), (dict(data=-1, model=2), 8),
    (dict(data=1, fsdp=2), 2), (dict(data=1, model=2), 2),
    (dict(data=1, expert=2), 2), (dict(data=2, expert=2), 4),
    (dict(data=2, fsdp=1, expert=2, model=2), 8),
    (dict(data=-1, pipeline=2, context=2), 8),
]
MESHES = [dict(data=1, fsdp=2), dict(data=1, model=2), dict(data=1, expert=2),
          dict(data=2, expert=2)]


def jax_ids(jm) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(jm.devices)


@pytest.mark.parametrize("kw,n", CONFIGS)
def test_mesh_device_order_matches_jax(kw, n, cpu_devices):
    from kubeflow_tpu.parallel import mesh as jmesh

    jm = jmesh.build_mesh(jmesh.MeshConfig(**kw), cpu_devices[:n])
    ids = [d.id for d in cpu_devices[:n]]
    tm = tmesh.build_mesh(tmesh.MeshConfig(**kw), devices=ids)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    np.testing.assert_array_equal(tm.devices, jax_ids(jm))
    np.testing.assert_array_equal(
        tmesh.mesh_device_array(tmesh.MeshConfig(**kw), ids), jax_ids(jm))
    assert tmesh.MeshConfig(**kw).sizes() == jmesh.MeshConfig(**kw).sizes()
    # the ranks a collective over the data-like axes spans, in batch order
    rank = ids[-1]
    flat = [int(r) for r in jax_ids(jm)[:, :, 0, :, 0, 0].reshape(-1)] \
        if tm.shape["pipeline"] == tm.shape["context"] \
        == tm.shape["model"] == 1 else None
    if flat is not None:
        assert tm.axis_ranks(tmesh.DATA_LIKE_AXES, rank) == flat
        assert tshard.data_index(tm, rank) == (flat.index(rank), len(flat))


@pytest.mark.parametrize("kw,n", [
    (dict(data=-1, fsdp=-1), 8), (dict(data=-1, fsdp=3), 8),
    (dict(data=2, fsdp=2), 8),
])
def test_mesh_errors_match_jax(kw, n, cpu_devices):
    from kubeflow_tpu.parallel import mesh as jmesh

    with pytest.raises(ValueError) as jerr:
        jmesh.build_mesh(jmesh.MeshConfig(**kw), cpu_devices[:n])
    with pytest.raises(ValueError) as terr:
        tmesh.build_mesh(tmesh.MeshConfig(**kw), devices=range(n))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("slices,kw", [
    (2, dict(data=2, fsdp=2, model=2)), (4, dict(data=4, model=2)),
    (2, dict(data=1, fsdp=1, model=8)), (4, dict(data=2, model=4)),
])
def test_multislice_mesh_matches_jax(slices, kw, cpu_devices):
    from kubeflow_tpu.parallel import mesh as jmesh

    cfg_j, cfg_t = jmesh.MeshConfig(**kw), tmesh.MeshConfig(**kw)
    try:
        jm = jmesh.build_multislice_mesh(slices, cfg_j, cpu_devices[:8])
    except ValueError as err:
        with pytest.raises(ValueError) as terr:
            tmesh.build_multislice_mesh(slices, cfg_t, devices=range(8))
        assert str(terr.value) == str(err)
        return
    tm = tmesh.build_multislice_mesh(slices, cfg_t, devices=range(8))
    np.testing.assert_array_equal(tm.devices, jax_ids(jm))


def test_single_device_mesh_and_manual_region():
    m = tmesh.single_device_mesh()
    assert m.shape == {a: 1 for a in tmesh.CANONICAL_ORDER}
    assert not tmesh.in_manual_region()
    with tmesh.manual_region():
        assert tmesh.in_manual_region()
    assert not tmesh.in_manual_region()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh(tmesh.MeshConfig(data=2), devices=[0, 1]) \
            .device_mesh  # noqa: B018


def _jax_param_shapes(model, x):
    import jax
    from flax import traverse_util

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    return {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(
        shapes["params"], sep="/").items()}


def _models():
    import jax.numpy as jnp

    from kubeflow_tpu.models import bert as jb
    from kubeflow_tpu.models import gpt as jg

    ids = jnp.ones((1, 8), jnp.int32)
    return {
        "gpt": (jg.GPTLM(jg.GPTConfig.tiny()), ids,
                tg.GPTLM(tg.GPTConfig.tiny(), device="cpu")),
        "llama-moe": (jg.GPTLM(jg.GPTConfig.llama(moe_experts=4)), ids,
                      tg.GPTLM(tg.GPTConfig.llama(moe_experts=4),
                               device="cpu")),
        "bert-moe": (jb.BertForSequenceClassification(
            jb.BertConfig.tiny(moe_experts=4), num_classes=2), ids,
            tb.BertForSequenceClassification(
                tb.BertConfig.tiny(moe_experts=4), num_classes=2,
                device="cpu")),
    }


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jm, x, tm) in _models().items():
        out[name] = (_jax_param_shapes(jm, x), jm.PARTITION_RULES, tm)
    return out


@pytest.mark.parametrize("mesh_kw", MESHES, ids=lambda kw: "x".join(
    f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("name", ["gpt", "llama-moe", "bert-moe"])
def test_partitioner_specs_match_jax(models, name, mesh_kw, cpu_devices):
    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel.partitioner import Partitioner as JPart

    shapes, jrules, port_model = models[name]
    n = int(np.prod(list(mesh_kw.values())))
    jp = JPart(mesh=jmesh.build_mesh(jmesh.MeshConfig(**mesh_kw),
                                     cpu_devices[:n]), path_specs=jrules)
    tp = tpart.Partitioner(
        mesh=tmesh.build_mesh(tmesh.MeshConfig(**mesh_kw), devices=range(n)),
        path_specs=port_model.PARTITION_RULES)
    layout = flax_layout(port_model)
    assert {p: s for p, s, _ in layout.values()} == shapes
    sharded = 0
    for path, shape in shapes.items():
        want = tuple(jp.spec_for(path, shape))
        assert tuple(tp.spec_for(path, shape)) == want, path
        sharded += any(a is not None for a in want)
    assert sharded  # every mesh shards some parameter of every model
    assert tp.key_fields() == jp.key_fields()


def test_rule_helpers_match_jax(cpu_devices):
    from jax.sharding import PartitionSpec as JP

    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel import partitioner as jpart
    from kubeflow_tpu.parallel import sharding as jshard

    jm = jmesh.build_mesh(jmesh.MeshConfig(data=2, fsdp=2, model=2),
                          cpu_devices[:8])
    tm = tmesh.build_mesh(tmesh.MeshConfig(data=2, fsdp=2, model=2),
                          devices=range(8))
    cases = [((), (64, 64)), (("fsdp", "model"), (64, 6)),
             (("fsdp", "model", None), (3, 8, 4)),
             ((("data", "fsdp"), None), (8, 2)), (("model",), (5,)),
             ((None, "fsdp", "model"), (4, 4))]
    for spec, shape in cases:
        assert tuple(tpart.fit_spec(spec, shape, tm)) == tuple(
            jpart.fit_spec(JP(*spec), shape, jm))
        assert tpart.spec_fits(spec, shape, tm) == jpart.spec_fits(
            JP(*spec), shape, jm)
    for shape, fs, mn in [((4096, 64), 2, 4096), ((10, 10), 2, 1),
                          ((6, 9, 12), 3, 1), ((7, 7), 2, 1),
                          ((64,), 2, 4096)]:
        assert tuple(tpart.heuristic_pspec(shape, fs, mn)) == tuple(
            jpart.heuristic_pspec(shape, fs, mn))
        assert tuple(tshard.fsdp_param_pspec(shape, fs, mn)) == tuple(
            jshard.fsdp_param_pspec(shape, fs, mn))
    rules = [(r"a/kernel$", JP("fsdp", "model")), (r"b$", JP("model"))]
    trules = [(p, tpart.P(*s)) for p, s in rules]
    for path, shape in [("x/a/kernel", (8, 8)), ("x/a/kernel", (3, 8)),
                        ("b", (6,)), ("c", (4096, 2)), ("c", ())]:
        assert tuple(tshard.state_pspec(path, shape, tm, trules)) == tuple(
            jshard.state_pspec(path, shape, jm, rules))
    assert tpart.path_str_of(["a", 0, "b"]) == "a/0/b"
    assert tuple(tshard.batch_pspec()) == tuple(jshard.batch_pspec())
    jp = jpart.Partitioner(mesh=jm, strict=True)
    tp = tpart.Partitioner(mesh=tm, strict=True)
    for pr in (jp, tp):
        with pytest.raises(ValueError, match="no logical axis rule"):
            pr.mesh_axes_for("nope")
    assert tp.mesh_axes_for("heads") == jp.mesh_axes_for("heads") == "model"
    assert tp.constrain_grads("g") == "g"
    with tp.deterministic_rng():
        pass


def test_comm_metrics_match_jax():
    from kubeflow_tpu.parallel import partitioner as jpart

    for p in (jpart, tpart):
        p.reset_comm_metrics()
        p.record_comm(0.25)
        p.record_comm(0.5, overlap_ratio=0.8)
    assert tpart.comm_metrics_snapshot() == jpart.comm_metrics_snapshot()
    for p in (jpart, tpart):
        p.reset_comm_metrics()
    assert tpart.comm_metrics_snapshot() == jpart.comm_metrics_snapshot()


def test_placements_and_batch_split():
    from torch.distributed.tensor import Replicate, Shard

    tm = tmesh.build_mesh(tmesh.MeshConfig(data=2, fsdp=2), devices=range(4))
    got = tpart.placements(tpart.P(None, "fsdp"), tm)
    assert got == [Replicate(), Shard(1)] + [Replicate()] * 4
    got = tpart.placements(tpart.P(("data", "fsdp")), tm)
    assert got[:2] == [Shard(0), Shard(0)]
    x = torch.arange(8)[:, None]
    rows = [tshard.put_global(x, tm, rank=r)[:, 0].tolist()
            for r in range(4)]
    assert rows == [[0, 1], [2, 3], [4, 5], [6, 7]]
    stacked = torch.arange(16).reshape(2, 8)
    part = tshard.shard_batch((stacked,), tm, stacked=True)
    assert isinstance(part, tshard.LocalBatch)
    assert tshard.shard_batch(part, tm) is part
    with pytest.raises(ValueError, match="not divisible"):
        tshard.put_global(torch.zeros(6), tm, rank=0)
    # the context axis executes: each rank of a data index takes its chunk
    # of the positions; the model axis is still refused
    tshard.refuse_unexecuted(tmesh.MeshConfig(context=2).sizes())
    tc = tmesh.build_mesh(tmesh.MeshConfig(data=2, context=2),
                          devices=range(4))
    seq = torch.arange(16).reshape(2, 8)
    got = [(tshard.put_global(seq, tc, rank=r)[:, 0].tolist(),
            tshard.put_sequence(seq, tc, rank=r)[0].tolist())
           for r in range(4)]
    assert got == [([0], [0, 1, 2, 3]), ([0], [4, 5, 6, 7]),
                   ([8], [0, 1, 2, 3]), ([8], [4, 5, 6, 7])]
    with pytest.raises(NotImplementedError, match="item 8"):
        tshard.refuse_unexecuted(tmesh.MeshConfig(context=2,
                                                  model=2).sizes())
