"""The port's pod tier against the JAX package's.

Pods of ``kubeflow_tpu_torch.serving.fleet`` (wire, podworker, podclient)
are held against ``kubeflow_tpu/serving/fleet`` in four ways, on a tiny
GPT in f32 on the CPU (the port's ``attention="flash"`` takes its plain
path there; every port pod's spec says ``"device": "cpu"``):

  (i) the chain codec: the same K/V in a JAX pool and a port pool
      serialize to equal payloads, each side decodes the other's, a bf16
      chain round-trips bit-exactly, a corrupt payload is refused and a
      partial insert freezes the chain;
  (ii) the worker's verb state machine in-process, with no socket: the
      port's ``PodServer.handle`` and the JAX ``PodServer.handle`` take
      one envelope sequence and give equal replies, tokens and counters,
      the port given the JAX init's weights as ``params``;
  (iii) real port subprocess pods, the drills of tests/test_pods.py: the
      tokens equal the JAX engine's, built as the JAX worker builds it;
  (iv) a port PodClient dials a JAX worker and gets a port pod's tokens.

The subprocess pods of (iii) run one intra-op thread each. The drills
that leave their pods serving share two pairs (one over AF_UNIX, one
over TCP, each spawned together when first used); a drill that kills,
stops, fences or adopts a pod spawns its own and reaps them when it
ends, so a few pods live at a time.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import gpt as jg
from kubeflow_tpu.serving.fleet import PagedKVPool as JaxPool
from kubeflow_tpu.serving.fleet import spawn_pod as jax_spawn_pod
from kubeflow_tpu.serving.fleet.podworker import PodServer as JaxPodServer
from kubeflow_tpu.serving.fleet.wire import (
    deserialize_chain as jax_deserialize_chain,
)
from kubeflow_tpu.serving.fleet.wire import (
    serialize_chain as jax_serialize_chain,
)
from kubeflow_tpu_torch.serving.fleet import (
    FleetRouter,
    FleetScaler,
    PagedKVPool,
    ScalerConfig,
    make_prompts,
    run_loadtest_sync,
    spawn_pod,
    wire_pod_deaths,
)
from kubeflow_tpu_torch.serving.fleet import podclient
from kubeflow_tpu_torch.serving.fleet.podclient import (
    PodClient,
    attach_router_death,
    next_fence_epoch,
    pod_metrics_snapshot,
)
from kubeflow_tpu_torch.serving.fleet.podworker import PodServer
from kubeflow_tpu_torch.serving.fleet.wire import (
    PodDead,
    PodDeadlineExpired,
    PodWireError,
    deserialize_chain,
    serialize_chain,
)
from kubeflow_tpu_torch.utils.envvars import (
    ENV_POD_NAME,
    ENV_POD_SOCKET,
    ENV_POD_SPEC,
)
from kubeflow_tpu_torch.utils.retry import Deadline

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

ROOT = Path(__file__).resolve().parent.parent
VOCAB, PROMPT, PREFIX, NEW = 64, 4, 2, 4
INIT_SEED = 7
MODEL = {"vocab_size": VOCAB, "hidden_size": 32, "num_layers": 1,
         "num_heads": 2, "mlp_dim": 64, "dropout_rate": 0.0,
         "max_len": PREFIX + PROMPT + NEW + 24}
#: K/V of the two packages' pools agree to this (f32, one layer)
KV_ATOL = 1e-5
#: one intra-op thread in every pod (the reference spawn's env_extra)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _jax_spec(**over) -> dict:
    """tests/test_pods.py's spec, without the JAX compile cache."""
    warm = make_prompts(1, seed=99, vocab=VOCAB, prompt_len=PROMPT,
                        shared_prefix=PREFIX)
    spec = {
        "model": dict(MODEL),
        "seed": 0, "init_seed": INIT_SEED, "max_rows": 2,
        "default_max_new_tokens": NEW, "eos_token_id": None,
        "prefill_chunk": 0,
        "pool": {"block_size": 4, "capacity_blocks": 256},
        "warmup_prompts": [[int(t) for t in p] for p in warm],
        "warmup_new_tokens": NEW, "warmup_repeats": 1,
        "warmup_resume": True,
        "max_queue": 64,
    }
    spec.update(over)
    return spec


def _spec(params: str, **over) -> dict:
    """The port pod's spec: the JAX one on the CPU, flash attention, the
    JAX init's weights."""
    spec = _jax_spec(**over)
    spec["model"] = {**spec["model"], "attention": "flash"}
    spec.update(device="cpu", params=params)
    return spec


def _prompt(seed: int) -> np.ndarray:
    return make_prompts(1, seed=seed, vocab=VOCAB, prompt_len=PROMPT,
                        shared_prefix=PREFIX)[0]


def _run_to_done(client, handles, timeout_s: float = 60.0) -> None:
    deadline = Deadline(timeout_s)
    while any(not h.done.is_set() for h in handles):
        client.tick()
        assert not deadline.expired(), "pod never finished the handles"


@pytest.fixture(scope="module")
def params(tmp_path_factory) -> str:
    """The JAX worker's weights (``podworker.py`` ``_build_engine``: init
    from ``init_seed`` at a (1, min(8, max_len)) input) as a flax-layout
    .npz for the port's ``params``."""
    cfg = jg.GPTConfig(**MODEL)
    variables = jax.jit(jg.GPTLM(cfg).init)(
        jax.random.PRNGKey(INIT_SEED),
        jnp.zeros((1, min(8, cfg.max_len)), jnp.int32))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        variables["params"], sep="/").items()}
    path = tmp_path_factory.mktemp("weights") / "params.npz"
    np.savez(path, **flat)
    return str(path)


@pytest.fixture(scope="module")
def jax_tokens():
    """Greedy tokens of the JAX engine built as the JAX worker builds it
    (its PodServer, in-process), per prompt."""
    engine = JaxPodServer("jax-ref", _jax_spec()).engine
    memo = {}

    def tokens(prompt, budget=NEW):
        key = (tuple(int(t) for t in prompt), budget)
        if key not in memo:
            h = engine.submit(np.asarray(prompt, np.int32),
                              max_new_tokens=budget)
            engine.run_until_idle()
            memo[key] = [int(t) for t in h.tokens]
        return memo[key]

    return tokens


@pytest.fixture(scope="module")
def state_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pods"))


def _spawn_group(names, params, state_dir, **kw) -> list:
    """Port pods spawned together (connect=False, then connect), sharing
    one router-side home pool."""
    pods = []
    try:
        for name in names:
            pods.append(spawn_pod(name, _spec(params), state_dir,
                                  connect=False, env_extra=ONE_THREAD,
                                  **kw))
        home = PagedKVPool(block_size=4, capacity_blocks=512)
        for c in pods:
            c.connect()
            c.paged_kv = home
    except BaseException:
        _reap(pods)
        raise
    return pods


def _reap(clients) -> None:
    for c in clients:
        c.partitioned = False
        c._disowned = False
        c.kill(timeout_s=2.0)
        c._kill_process()


@pytest.fixture(scope="module")
def unix_pods(params, state_dir):
    """The AF_UNIX pair the non-destructive drills share."""
    pods = _spawn_group(("shared-0", "resume-1"), params, state_dir)
    yield {c.name: c for c in pods}
    _reap(pods)


@pytest.fixture(scope="module")
def tcp_pods(params, state_dir):
    """The TCP pair the non-destructive drills share."""
    pods = _spawn_group(("tcp-0", "tcp-1"), params, state_dir,
                        transport="tcp")
    yield {c.name: c for c in pods}
    _reap(pods)


@pytest.fixture
def own_pods(params, state_dir):
    """spawn(*names, **kw) -> pods for one drill, reaped when it ends."""
    made = []

    def spawn(*names, **kw):
        pods = _spawn_group(names, params, state_dir, **kw)
        made.extend(pods)
        return pods

    yield spawn
    _reap(made)


# ------------------------------------------------------------ (i) codec


def _chain_material(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, size=n).astype(np.int32)
    kv = {"l0/k": rng.standard_normal((n, 2, 4)).astype(np.float32),
          "l0/v": rng.standard_normal((n, 2, 4)).astype(np.float32)}
    return ids, kv


def _torch_kv(kv, dtype=torch.float32):
    return {p: torch.from_numpy(a).to(dtype) for p, a in kv.items()}


def test_codec_payload_equals_jax_codec():
    """The same numpy K/V inserted into a JAX pool and a port pool
    serialize to equal payloads: n, ids, every K/V leaf (shape, dtype tag
    and base64 bytes), the digests and the sha256."""
    ids, kv = _chain_material(10)
    jpool, pool = JaxPool(4, 64), PagedKVPool(4, 64)
    want = jax_serialize_chain(jpool, jpool.insert(ids, kv))
    got = serialize_chain(pool, pool.insert(ids, _torch_kv(kv)))
    assert set(got) == {"n", "ids", "kv", "refs", "sha256"}
    assert got == want
    assert got["kv"]["l0/k"]["dtype"] == "float32"


def test_codec_each_side_decodes_the_other():
    ids, kv = _chain_material(10, seed=4)
    jsrc, src = JaxPool(4, 64), PagedKVPool(4, 64)
    jax_payload = jax_serialize_chain(jsrc, jsrc.insert(ids, kv))
    port_payload = serialize_chain(src, src.insert(ids, _torch_kv(kv)))
    dst = PagedKVPool(4, 64)
    chain = deserialize_chain(dst, jax_payload)
    got_ids, got_kv = dst.gather(chain.refs)
    np.testing.assert_array_equal(got_ids, ids)
    for p in kv:
        np.testing.assert_array_equal(got_kv[p].numpy(), kv[p])
    jdst = JaxPool(4, 64)
    jchain = jax_deserialize_chain(jdst, port_payload)
    assert [d.hex() for d in jchain.refs] == port_payload["refs"]
    jids, jkv = jdst.gather(jchain.refs)
    np.testing.assert_array_equal(jids, ids)
    for p in kv:
        np.testing.assert_array_equal(np.asarray(jkv[p]), kv[p])
    chain.release()
    jchain.release()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_round_trip_bit_exact(dtype):
    """A chain in the pool's storage dtype — bf16 on the card — crosses
    bit for bit, tagged with the bare dtype name; the receiver re-derives
    the sender's digests."""
    ids, kv = _chain_material(10, seed=5)
    tkv = _torch_kv(kv, dtype)
    src, dst = PagedKVPool(4, 64), PagedKVPool(4, 64)
    ser = serialize_chain(src, src.insert(ids, tkv))
    assert {s["dtype"] for s in ser["kv"].values()} \
        == {str(dtype).removeprefix("torch.")}
    chain = deserialize_chain(dst, json.loads(json.dumps(ser)))
    assert not chain.frozen and chain.length == 10
    got_ids, got_kv = dst.gather(chain.refs)
    np.testing.assert_array_equal(got_ids, ids)
    for p in tkv:
        assert got_kv[p].dtype == dtype
        assert torch.equal(got_kv[p].view(torch.int16 if dtype
                                          == torch.bfloat16 else dtype),
                           tkv[p].view(torch.int16 if dtype
                                       == torch.bfloat16 else dtype))
    assert [d.hex() for d in chain.refs] == ser["refs"]
    chain.release()


def test_codec_corrupt_payload_refused():
    src = PagedKVPool(block_size=4, capacity_blocks=64)
    ids, kv = _chain_material(10)
    ser = serialize_chain(src, src.insert(ids, _torch_kv(kv)))
    # flip one byte of one K/V leaf: sha256 over the raw bytes
    torn = {**ser, "kv": {**ser["kv"]}}
    path = sorted(torn["kv"])[0]
    b64 = torn["kv"][path]["b64"]
    torn["kv"][path] = {**torn["kv"][path],
                        "b64": ("A" if b64[0] != "A" else "B") + b64[1:]}
    with pytest.raises(PodWireError):
        deserialize_chain(PagedKVPool(4, 64), torn)
    # a tampered digest list is caught even when the bytes verify
    lied = {**ser, "refs": ["00" * 20] + ser["refs"][1:]}
    with pytest.raises(PodWireError):
        deserialize_chain(PagedKVPool(4, 64), lied)


def test_codec_partial_insert_yields_frozen_chain():
    """A receiving pool already holding a LONGER partial with the same
    content prefix stops the re-insert early: the codec hands back a
    FROZEN chain, never silently wrong K/V."""
    src, dst = PagedKVPool(4, 64), PagedKVPool(4, 64)
    ids, kv = _chain_material(10)  # 2 full blocks + a 2-position tail
    tkv = _torch_kv(kv)
    ser = serialize_chain(src, src.insert(ids, tkv))
    held = dst.insert(np.concatenate([ids, ids[:1]]),
                      {p: torch.cat([a, a[:1]]) for p, a in tkv.items()})
    chain = deserialize_chain(dst, ser)
    assert chain.frozen
    chain.release()
    dst.release(held)


# -------------------------------------------- (ii) the verb state machine


def _normalized(reply: dict) -> dict:
    """A reply as the wire carries it, without the timing fields of done
    events and with a chain reduced to what both packages share (its K/V
    leaves are named after each package's cache)."""
    out = json.loads(json.dumps(reply))
    for ev in out.get("events", ()):
        ev.pop("ttft_s", None)
        ev.pop("tps", None)
        if ev.get("chain"):
            ev["chain"] = {k: ev["chain"][k] for k in ("n", "ids", "refs")}
    return out


def _chains(replies) -> list[dict]:
    return [ev["chain"] for r in replies for ev in r.get("events", ())
            if ev.get("chain")]


def test_verb_state_machine_matches_jax_podserver(params):
    """One envelope sequence through both workers' handle(): hello, a
    submit and its duplicate, ticks with and without acks, a hello that
    adopts a newer epoch and purges, a 410 on the stale epoch, 504 on a
    spent deadline, 400 on an unknown verb, 503 on a full queue, a
    keep_chain retire, 409 on a resume that freezes, 500 from the engine —
    equal replies, tokens and counters."""
    jspec = _jax_spec(max_queue=2)
    jax_srv = JaxPodServer("verbs", jspec)
    srv = PodServer("verbs", _spec(params, max_queue=2))
    p1, p2, p3 = _prompt(61), _prompt(62), _prompt(63)
    # a resume that cannot cover its positions in either worker's pool:
    # both pools already hold a longer partial sibling of its tail
    ids, kv = _chain_material(10, seed=6)
    jsrc = JaxPool(4, 64)
    frozen_payload = jax_serialize_chain(jsrc, jsrc.insert(ids, kv))
    longer_ids = np.concatenate([ids, ids[:1]])
    jax_srv.pool.insert(longer_ids, {p: np.concatenate([a, a[:1]])
                                     for p, a in kv.items()})
    srv.pool.insert(longer_ids, {p: torch.from_numpy(
        np.concatenate([a, a[:1]])) for p, a in kv.items()})

    def submit(seq, rid, prompt, epoch, **kw):
        return {"verb": "submit", "seq": seq, "epoch": epoch, "rid": rid,
                "prompt": [int(t) for t in prompt], "max_new_tokens": NEW,
                "eos": None, "temperature": 0.0, "keep_chain": False,
                "resume": None, **kw}

    def tick(seq, epoch, ack=0, n=1, **kw):
        return {"verb": "tick", "seq": seq, "epoch": epoch, "ack": ack,
                "n": n, **kw}

    script = [
        {"verb": "hello", "seq": 1, "epoch": 0},
        submit(2, "a", p1, 0),
        submit(3, "a", p1, 0),                  # duplicate: dup=True
        tick(4, 0),
        tick(5, 0),                             # unacked: redelivered
        {"verb": "hello", "seq": 6, "epoch": 3},  # adopt + purge
        tick(7, 3),
        submit(8, "a", p1, 3),                  # purged: not a dup
        submit(9, "b", p2, 3),
        submit(10, "c", p3, 3),                 # queue full: 503
        tick(11, 1),                            # stale epoch: 410
        tick(12, 3, deadline_s=0.0),            # spent deadline: 504
        {"verb": "bogus", "seq": 13, "epoch": 3},  # 400
        tick(14, 3, n=8),                       # the queue drains
        submit(15, "k", p3, 3, keep_chain=True),
        submit(16, "r", p2, 3, resume={"chain": frozen_payload,
                                       "tokens": [1]}),  # frozen: 409
        submit(17, "x", np.ones(40, np.int32), 3),  # too long: 500
        {"verb": "heartbeat", "seq": 18, "epoch": 3},
        {"verb": "drain", "seq": 19, "epoch": 3},
    ]
    replies = {"jax": [], "port": []}
    for env in script:
        replies["jax"].append(jax_srv.handle(dict(env)))
        replies["port"].append(srv.handle(dict(env)))
    # ticks with cumulative acks until both engines are idle
    seq, acked = 20, 0
    for _ in range(60):
        env = tick(seq, 3, ack=acked, n=2)
        j, t = jax_srv.handle(dict(env)), srv.handle(dict(env))
        replies["jax"].append(j)
        replies["port"].append(t)
        if j.get("events"):
            acked = j["events"][-1]["id"]
        seq += 1
        if not j["busy"] and not t["busy"] and j["depth"] == 0:
            break
    codes = [(r.get("code"), r["ok"]) for r in replies["port"][:19]]
    assert codes[9] == (503, False) and codes[10] == (410, False)
    assert codes[11] == (504, False) and codes[12] == (400, False)
    assert codes[15] == (409, False) and codes[16] == (500, False)
    assert [ok for _, ok in codes].count(False) == 6
    assert replies["port"][2]["dup"] is True
    assert "dup" not in replies["port"][7]
    assert replies["port"][5]["epoch"] == 3
    # the engines' messages for the 500 are their own: code and type only
    for side in replies.values():
        side[16]["error"] = side[16]["error"].split(":")[0]
    assert [_normalized(r) for r in replies["port"]] \
        == [_normalized(r) for r in replies["jax"]]
    done = [ev for r in replies["port"] for ev in r.get("events", ())
            if ev["ev"] == "done"]
    assert {ev["rid"] for ev in done} == {"a", "b", "k"}
    assert all(len(ev["tokens"]) == NEW and ev["error"] is None
               for ev in done)
    # the keep_chain retire's K/V: every leaf within KV_ATOL
    (jchain,), (chain,) = _chains(replies["jax"]), _chains(replies["port"])
    jpool, pool = JaxPool(4, 64), PagedKVPool(4, 64)
    jids, jleaves = jpool.gather(jax_deserialize_chain(jpool, jchain).refs)
    tids, tleaves = pool.gather(deserialize_chain(pool, chain).refs)
    np.testing.assert_array_equal(tids, jids)
    for kind, leaf in (("key", "cached_key"), ("value", "cached_value")):
        np.testing.assert_allclose(
            tleaves[f"layer_0/{kind}"].numpy(),
            np.asarray(jleaves[f"/layer_0/attention/{leaf}"]),
            atol=KV_ATOL, rtol=0)
    for attr in ("step_count", "prefill_tokens_total",
                 "prefill_tokens_reused"):
        assert getattr(srv.engine, attr) == getattr(jax_srv.engine, attr)
    assert srv.pool.metrics == jax_srv.pool.metrics
    assert srv._next_event_id == jax_srv._next_event_id


def test_worker_refuses_unported_keys_and_a_missing_card(params, tmp_path):
    with pytest.raises(NotImplementedError, match="Queue A item"):
        PodServer("refuse", _spec(params, chaos_decode_repeats=2))
    # compile_cache_dir is honoured: the kernel libraries live there on the
    # card, and on the CPU (the plain versions) nothing is built
    from kubeflow_tpu_torch.utils.compile_cache import compile_counts

    before = compile_counts()
    PodServer("cache", _spec(params, compile_cache_dir=str(tmp_path)))
    assert compile_counts() == before and not any(tmp_path.iterdir())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PodServer("nocard", {**_spec(params), "device": "cuda"})


def test_spawn_starts_the_port_worker_in_this_tree(params, tmp_path,
                                                   monkeypatch):
    """spawn_pod launches the port's worker module from the repository
    root, adds no JAX_PLATFORMS, and makes the spec's paths absolute."""
    seen = {}

    class Launch:
        pid = 0

        def __init__(self, args, env, cwd, **kw):
            seen.update(args=args, env=env, cwd=cwd)

        def poll(self):
            return 0

        def kill(self):
            pass

        def wait(self, timeout=None):
            return 0

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(podclient.subprocess, "Popen", Launch)
    monkeypatch.chdir(tmp_path)
    c = spawn_pod("launch-0", {**_spec(params), "params": "rel.npz"},
                  "state", connect=False)
    assert seen["args"] == [sys.executable, "-m",
                            "kubeflow_tpu_torch.serving.fleet.podworker"]
    assert Path(seen["cwd"]) == ROOT
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
    assert "JAX_PLATFORMS" not in seen["env"]
    spec = json.loads(Path(seen["env"][ENV_POD_SPEC]).read_text())
    assert spec["params"] == str(tmp_path / "rel.npz")
    assert Path(seen["env"][ENV_POD_SOCKET]).is_absolute()
    c._quiet_dead("test")


def test_pod_without_a_card_fails_at_startup(params, state_dir):
    """A pod asked for the card on a machine without one exits before it
    is ready: connect() raises, nothing serves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(PodDead, match="before ready"):
        spawn_pod("nocard-0", {**_spec(params), "device": "cuda"},
                  state_dir, env_extra=ONE_THREAD, startup_timeout_s=60.0)
    log = Path(state_dir, "nocard-0.stderr.log").read_text()
    assert "no CUDA device" in log


# ------------------------------------------------- (iii) subprocess pods


def test_spawn_serve_deterministic_equal_to_jax_engine(unix_pods,
                                                       jax_tokens):
    pod = unix_pods["shared-0"]
    assert pod.worker_pid is not None and pod.worker_pid > 0
    assert pod.default_max_new_tokens == NEW
    p = _prompt(11)
    h1 = pod.submit(p, max_new_tokens=NEW)
    _run_to_done(pod, [h1])
    assert h1.error is None and len(h1.tokens) == NEW
    h2 = pod.submit(p, max_new_tokens=NEW)
    _run_to_done(pod, [h2])
    assert h2.tokens == h1.tokens == jax_tokens(p)
    assert pod.step_count > 0
    assert pod.prefill_tokens_total > 0
    assert pod._queue == [] and pod._rows == []
    assert pod.heartbeat_age() is not None
    assert pod.heartbeat_age() < 30.0


def test_deadline_propagates_to_worker_504(unix_pods):
    pod = unix_pods["shared-0"]
    base = pod_metrics_snapshot()["deadline_rejects_total"]
    d = Deadline(1e-9)
    time.sleep(0.01)
    with pytest.raises(PodDeadlineExpired):
        pod.call("heartbeat", deadline=d)
    assert pod_metrics_snapshot()["deadline_rejects_total"] == base + 1
    assert pod.call("heartbeat")["ok"]  # only the budget was refused


def test_torn_frame_retried_submit_idempotent(unix_pods, jax_tokens):
    """A reply torn mid-frame is retried by the wire policy; the worker
    dedupes the re-sent rid, so the row seats ONCE."""

    class OneTear:
        def __init__(self):
            self.left = 1

        def on_wire_op(self):
            if self.left:
                self.left -= 1
                return "torn"
            return None

    pod = unix_pods["shared-0"]
    base = pod_metrics_snapshot()["wire_retries_total"]
    pod.chaos = OneTear()
    try:
        h = pod.submit(_prompt(12), max_new_tokens=NEW)
    finally:
        pod.chaos = None
    _run_to_done(pod, [h])
    assert h.error is None
    assert h.tokens == jax_tokens(_prompt(12))  # seated once, never twice
    assert pod_metrics_snapshot()["wire_retries_total"] > base


def _handoff(a, b, jax_tokens):
    """Pod a decodes with keep_chain, its chain crosses into the home
    pool, pod b resumes from it: token-identical to a straight run."""
    p = _prompt(13)
    base = pod_metrics_snapshot()["handoff_bytes_total"]
    h = a.submit(p, max_new_tokens=NEW, keep_chain=True)
    _run_to_done(a, [h])
    assert h.chain is not None and not h.chain.frozen
    assert h.chain.pool is a.paged_kv  # adopted into the HOME pool
    assert pod_metrics_snapshot()["handoff_bytes_total"] > base
    keep = int(h.chain.length) - int(p.size) + 1
    assert 0 < keep <= len(h.tokens)
    r = b.submit(p, max_new_tokens=NEW,
                 resume_from=(h.chain, h.tokens[:keep]))
    _run_to_done(b, [r])
    assert r.error is None and r.resumed
    assert r.tokens == h.tokens == jax_tokens(p)
    assert r.recovery_chain is None  # the home hold was released


def test_chain_handoff_resume_across_pods(unix_pods, jax_tokens):
    _handoff(unix_pods["shared-0"], unix_pods["resume-1"], jax_tokens)


def test_drain_then_reap(own_pods, jax_tokens):
    (c,) = own_pods("drain-0")
    hs = [c.submit(_prompt(20 + i), max_new_tokens=NEW) for i in range(3)]
    assert c.drain(timeout_s=60.0)
    for i, h in enumerate(hs):
        assert h.done.is_set() and h.error is None
        assert h.tokens == jax_tokens(_prompt(20 + i))
    c.kill(timeout_s=5.0)
    assert c.dead
    assert c.proc.poll() is not None  # reaped, not orphaned


def test_orphaned_worker_reaped_on_spawner_death(params, tmp_path):
    """A SIGKILLed spawner runs no teardown — the worker's kernel
    pdeathsig watchdog must reap it anyway."""
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(_spec(params)))
    launcher = (
        "import os, subprocess, sys\n"
        "env = dict(os.environ)\n"
        f"env[{ENV_POD_SPEC!r}] = {str(spec_path)!r}\n"
        f"env[{ENV_POD_SOCKET!r}] = {str(tmp_path / 'w.sock')!r}\n"
        f"env[{ENV_POD_NAME!r}] = 'orphan-0'\n"
        "env['OMP_NUM_THREADS'] = '1'\n"
        "p = subprocess.Popen([sys.executable, '-m',"
        " 'kubeflow_tpu_torch.serving.fleet.podworker'], env=env,"
        f" cwd={str(ROOT)!r}, stderr=subprocess.DEVNULL)\n"
        "print(p.pid, flush=True)\n"
    )
    out = subprocess.run([sys.executable, "-c", launcher],
                         capture_output=True, text=True, timeout=60)
    worker_pid = int(out.stdout.strip())
    deadline = Deadline(30.0)
    while True:
        try:
            os.kill(worker_pid, 0)
        except ProcessLookupError:
            break  # reaped by the kernel, as armed
        if deadline.expired():
            os.kill(worker_pid, signal.SIGKILL)
            pytest.fail("orphaned worker outlived its spawner")
        time.sleep(0.1)


def test_sigkill_mid_decode_zero_drop_chain_resume(own_pods, jax_tokens):
    """A prefill pod and two decode pods behind the router; decode pod 0
    SIGKILLed by PID at the first tick at which it holds rows that have
    tokens. Zero drops, at least one requeue resumed from the home-pool
    chain, every request's tokens the JAX engine's."""
    roles = (("pf-0", "prefill"), ("dc-0", "decode"), ("dc-1", "decode"))
    clients = own_pods(*(n for n, _ in roles))
    router = FleetRouter([(c.name, c, role)
                          for c, (_, role) in zip(clients, roles)])
    wire_pod_deaths(router)
    victim = clients[1]
    prompts = make_prompts(6, seed=31, vocab=VOCAB, prompt_len=PROMPT,
                           shared_prefix=PREFIX)
    handles = []
    submit = router.submit

    def keep(*a, **kw):
        handles.append(submit(*a, **kw))
        return handles[-1]

    router.submit = keep
    for c in clients:
        c.tick()  # idle: mirrors the workers' counters (warmup included)
    base_prefill = clients[2].prefill_tokens_total
    killed = {"done": False}

    def on_tick(tick, _rtr):
        if not killed["done"] and any(h.tokens for h in victim._rows):
            killed["done"] = True
            os.kill(victim.worker_pid, signal.SIGKILL)

    report = run_loadtest_sync(router, prompts, seed=31,
                               mean_gap_ticks=1.0, new_tokens=NEW,
                               on_tick=on_tick)
    rs = report.summary()
    assert killed["done"]
    assert rs["dropped"] == 0
    assert rs["completed"] == len(prompts)
    assert rs["requeued"] >= 1
    assert rs["resumed"] == rs["requeued"]  # chain rescue, not scratch
    (vrep,) = [r for r in router.replicas if r.engine is victim]
    assert not vrep.alive and victim.dead
    assert victim.proc.poll() == -signal.SIGKILL
    assert all(c.proc.poll() is None for c in (clients[0], clients[2]))
    assert router.metrics["replica_kills_total"] >= 1
    assert router.metrics["prefill_handoffs_total"] == len(prompts)
    # no prompt position computed on the surviving decode pod
    assert clients[2].prefill_tokens_total == base_prefill
    for h in handles:
        assert [int(t) for t in h.tokens] == jax_tokens(h.prompt)


def test_admission_window_kill_repicks(own_pods, jax_tokens):
    """A pod dying between admission and seating: the dispatch loop
    flips the replica, re-picks a survivor and loses nothing."""
    clients = own_pods("adm-0", "adm-1")
    router = FleetRouter([(c.name, c) for c in clients])
    wire_pod_deaths(router)
    os.kill(clients[0].worker_pid, signal.SIGKILL)
    reqs = [router.submit(_prompt(40 + i), max_new_tokens=NEW)
            for i in range(4)]
    survivor = clients[1]
    deadline = Deadline(60.0)
    while any(not r.done.is_set() for r in reqs):
        survivor.tick()
        assert not deadline.expired()
    for i, r in enumerate(reqs):
        assert r.error is None
        assert r.result(timeout=1).tolist() == jax_tokens(_prompt(40 + i))
    assert router.metrics["requests_failed_total"] == 0
    (corpse,) = [r for r in router.replicas if r.engine is clients[0]]
    assert not corpse.alive


def test_sigstop_hang_indicted_by_heartbeat_and_replaced(
        own_pods, params, state_dir, jax_tokens):
    """SIGSTOP keeps the socket and the mirrored counters — only the
    heartbeat stops. The port's FleetScaler indicts the pod by beat age,
    kills it, spawns a replacement, and the request completes there."""
    (a,) = own_pods("stop-0")
    router = FleetRouter([(a.name, a)])
    wire_pod_deaths(router)
    spawned = []

    def factory():
        c = spawn_pod(f"stop-repl-{len(spawned)}", _spec(params),
                      state_dir, home_pool=a.paged_kv,
                      env_extra=ONE_THREAD)
        attach_router_death(c, router)
        spawned.append(c)
        return c

    scaler = FleetScaler(
        router, factory,
        ScalerConfig(min_replicas=1, max_replicas=2,
                     hang_detect_evals=10 ** 6,  # heartbeat-only
                     heartbeat_max_age_s=1.0))
    try:
        req = router.submit(_prompt(50), max_new_tokens=NEW)
        a.tick()  # a beat exists; the row is seated
        os.kill(a.worker_pid, signal.SIGSTOP)
        time.sleep(1.3)  # the beat goes stale past the ceiling
        deadline = Deadline(120.0)
        while scaler.metrics["hangs_detected_total"] < 1:
            scaler.evaluate()
            assert not deadline.expired(), "hang never indicted"
            time.sleep(0.05)
        for c in spawned:  # the scaler leaves new engines passive
            c.start()
        assert req.result(timeout=60).tolist() == jax_tokens(_prompt(50))
        assert router.metrics["requests_requeued_total"] >= 1
        assert a.dead  # the corpse was reaped, not leaked
        assert len(spawned) == 1
    finally:
        for c in spawned:
            c.stop()
            c.kill(timeout_s=2.0)


def test_tcp_severed_connection_replays_idempotently(tcp_pods, jax_tokens):
    c = tcp_pods["tcp-0"]
    assert c._transport is not None and c._transport.kind == "tcp"
    base = pod_metrics_snapshot()
    h = c.submit(_prompt(31), max_new_tokens=NEW)
    c.tick()  # at least one round-trip lands on the doomed socket
    c._transport.sock.shutdown(socket.SHUT_RDWR)  # the reset
    _run_to_done(c, [h])
    assert h.error is None
    assert h.tokens == jax_tokens(_prompt(31))  # replayed, never doubled
    now = pod_metrics_snapshot()
    assert now["net_reconnects_total"] > base["net_reconnects_total"]
    assert now["wire_retries_total"] > base["wire_retries_total"]


def test_stale_epoch_refused_both_directions(own_pods, jax_tokens):
    """A successor client with a higher fence epoch adopts the worker;
    the predecessor's next frame is answered 410 — it fences itself and
    is disowned WITHOUT killing the process, and even its bypass-fence
    probe stays refused. The successor decodes untouched."""
    (a,) = own_pods("epoch-0", transport="tcp")
    first = a.submit(_prompt(40), max_new_tokens=NEW)
    _run_to_done(a, [first])
    with a._wire_mu:
        a._close_socket()  # one connection at a time: step aside
    b = PodClient("epoch-0", a.socket_path, proc=None,
                  heartbeat_path=a.heartbeat_path, transport="tcp",
                  port_file=a.port_file, epoch=next_fence_epoch())
    b.paged_kv = a.paged_kv
    try:
        b.connect(timeout_s=60.0)
        base = pod_metrics_snapshot()["net_fenced_frames_total"]
        with b._wire_mu:
            b._close_socket()  # let the stale client redial
        assert a.tick() is False
        assert a.fenced and a.dead and a._disowned
        assert a.proc.poll() is None  # belongs to the successor now
        assert pod_metrics_snapshot()["net_fenced_frames_total"] > base
        with pytest.raises(PodDead):
            a.fenced_poll(timeout_s=5.0)
        r = b.submit(_prompt(40), max_new_tokens=NEW)
        _run_to_done(b, [r])
        assert r.error is None
        assert r.tokens == first.tokens == jax_tokens(_prompt(40))
    finally:
        b._close_socket()


def test_partition_heal_split_brain_refused(own_pods):
    """A partition mid-decode burns the retry budget; the death FENCES
    instead of killing — the worker runs on. After the heal every late
    delivery of the fenced claim is refused."""
    (c,) = own_pods("part-0", transport="tcp", op_timeout_s=2.0)
    h = c.submit(_prompt(41), max_new_tokens=NEW)
    c.tick()  # the row is seated; maybe a token or two landed
    ntoks = len(h.tokens)
    base = pod_metrics_snapshot()
    c.set_partitioned(True)
    assert c.tick() is False  # retries exhausted -> pod death
    assert c.dead and c.fenced
    assert c.proc.poll() is None  # the worker SURVIVED
    assert h.done.is_set() and h.error is not None
    c.set_partitioned(False)  # the heal
    probe = c.fenced_poll(timeout_s=5.0)
    assert probe["late_events"] >= 1
    assert probe["refused"] == probe["late_events"]
    assert len(h.tokens) == ntoks  # not one late token applied
    now = pod_metrics_snapshot()
    assert now["net_partitions_injected_total"] == \
        base["net_partitions_injected_total"] + 1
    assert now["net_fenced_frames_total"] > base["net_fenced_frames_total"]
    assert now["wire_retries_exhausted_total"] > \
        base["wire_retries_exhausted_total"]


def test_chain_handoff_resume_across_tcp_pods(tcp_pods, jax_tokens):
    _handoff(tcp_pods["tcp-0"], tcp_pods["tcp-1"], jax_tokens)


# ------------------------------------------- (iv) the port against a JAX pod


def test_port_client_dials_a_jax_worker(unix_pods, state_dir):
    """The port's PodClient drives a JAX worker (spawned by the JAX
    package's spawn_pod) and gets the tokens a port pod with the same
    weights gives: the port's frames are the reference's."""
    jax_pod = jax_spawn_pod("jax-0", _jax_spec(), state_dir,
                            env_extra=ONE_THREAD)
    c = PodClient("jax-0", jax_pod.socket_path, heartbeat_path=None,
                  epoch=max(next_fence_epoch(), jax_pod.epoch + 1))
    c.paged_kv = PagedKVPool(4, 256)
    with jax_pod._wire_mu:
        jax_pod._close_socket()  # the worker serves one connection
    pod = unix_pods["shared-0"]
    try:
        c.connect(timeout_s=60.0)
        assert c.worker_pid == jax_pod.worker_pid
        for seed in (71, 72):
            p = _prompt(seed)
            got = c.submit(p, max_new_tokens=NEW)
            _run_to_done(c, [got])
            want = pod.submit(p, max_new_tokens=NEW)
            _run_to_done(pod, [want])
            assert got.error is None and len(got.tokens) == NEW
            assert got.tokens == want.tokens
    finally:
        c._close_socket()
        jax_pod.kill(timeout_s=2.0)
        jax_pod._kill_process()
