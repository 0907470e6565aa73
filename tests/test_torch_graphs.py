"""The Trainer's CUDA graphs of fused steps, on a card.

Marked ``cuda``: each test decides inside itself whether a card is there
and skips without one (a CUDA graph has no CPU mode; on the CPU a chunk is
k eager steps, held by tests/test_torch_trainer_extras.py). No JAX here, so
the file runs on the machine with the card:

    python -m pytest tests/test_torch_graphs.py -m cuda

A tiny GPT (2 layers, hidden 32, head_dim 16, bf16 compute, flash
attention: the four hand-written kernels run inside the graphs).
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.kernels import KERNELS
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.train import data as td
from kubeflow_tpu_torch.train import metrics as tm
from kubeflow_tpu_torch.train import trainer as tt
from kubeflow_tpu_torch.train.checkpoint import Checkpointer

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            mlp_dim=64, max_len=16, dropout_rate=0.0, attention="flash")
DATA = dict(n_train=40, n_test=8, seq_len=16, vocab_size=64)
B = 4


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")


def trainer(fused_steps, seed=0, **cfg):
    model = tg.GPTLM(tg.GPTConfig.tiny(**TINY), device="cuda").init_weights(
        torch.Generator().manual_seed(seed))
    config = {"batch_size": B, "learning_rate": 1e-2, "warmup_steps": 2,
              "grad_clip_norm": 0.5, "fused_steps": fused_steps, **cfg}
    return tt.Trainer(model, tt.TrainerConfig(**config),
                      loss_fn=tg.causal_lm_loss,
                      eval_metrics_fn=tg.causal_lm_eval_metrics)


def counts():
    return {n: k.launches for n, k in KERNELS.items()}


def chunk_of(ds, k, first=0):
    return tuple(np.stack([a[(first + i) * B:(first + i + 1) * B]
                           for i in range(k)])
                 for a in (ds.x_train, ds.y_train))


@pytest.mark.cuda
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_written_out_update_is_torchs_on_card(weight_decay):
    """The graph's optimizer update (_adam_update with its scalars in a
    device tensor) equals torch's multi-tensor Adam/AdamW step on the card
    bit for bit, three steps running."""
    need_card()
    ds = td.synthetic_lm_dataset(**DATA)
    runs = []
    for written in (False, True):
        tr = trainer(1, weight_decay=weight_decay)
        state = tr.init_state()
        for i in range(4):
            batch = tuple(a[i * B:(i + 1) * B]
                          for a in (ds.x_train, ds.y_train))
            if written and i:  # step 0 makes Adam's state
                row = tr._update_scalars(state, 1)[0].cuda()

                def update(st, row=row):
                    tt._adam_update(st.optimizer, row)
                    for s in st.optimizer.state.values():
                        s["step"] += 1

                state, _ = tr._step(state, batch, update)
            else:
                state, _ = tr.train_step(state, batch)
        runs.append(state)
    for (name, a), b in zip(runs[0].model.named_parameters(),
                            runs[1].model.parameters()):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_graphed_chunk_equals_its_steps_one_by_one():
    """One replay of a 4-step graph moves the parameters bit for bit as the
    same 4 steps taken one by one (torch's Adam); the warm-up before the
    capture leaves no trace; each replay adds 4 launches a layer of every
    flash kernel, the capture none."""
    need_card()
    ds = td.synthetic_lm_dataset(**DATA)
    k, layers = 4, TINY["num_layers"]
    graphed = trainer(k)
    state = graphed.init_state()
    before = counts()
    state, m = graphed.train_chunk(state, chunk_of(ds, k), k)
    torch.cuda.synchronize()
    assert graphed.graph_warmups == tt.GRAPH_WARMUP_STEPS
    assert state.step == k
    per = layers * (k + graphed.graph_warmups)
    assert {n: c - before[n] for n, c in counts().items()} == {
        n: per if n.startswith("flash") else 0 for n in KERNELS}
    eager = trainer(1)
    ref = eager.init_state()
    for i in range(k):
        ref, rm = eager.train_step(ref, tuple(a[i] for a in chunk_of(ds, k)))
    torch.cuda.synchronize()
    for (name, a), b in zip(state.model.named_parameters(),
                            ref.model.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(state.optimizer.state.values(),
                    ref.optimizer.state.values()):
        assert all(torch.equal(a[key], b[key]) for key in a)
    assert torch.equal(m["loss"], rm["loss"])
    # a second chunk replays the same graph: k launches a layer, no warm-up
    before = counts()
    state, m2 = graphed.train_chunk(state, chunk_of(ds, k, first=k), k)
    torch.cuda.synchronize()
    assert graphed.graph_warmups == tt.GRAPH_WARMUP_STEPS
    assert {n: c - before[n] for n, c in counts().items()} == {
        n: layers * k if n.startswith("flash") else 0 for n in KERNELS}
    assert state.step == 2 * k and np.isfinite(float(m2["loss"]))


@pytest.mark.cuda
def test_graphed_fit_and_checkpoints_cross(tmp_path, capsys):
    """fit(fused_steps=4) logs the losses of fit(fused_steps=1) at the same
    steps and ends at its parameters, bit for bit; its checkpoint restores
    into an eager
    trainer and the next step's loss is the same on both sides, and the
    reverse, after which a graph captures over the restored state."""
    need_card()
    ds = td.synthetic_lm_dataset(**DATA)
    logged, params = {}, {}
    for k in (1, 4):
        tr = trainer(k, steps=11, log_every_steps=1,
                     checkpoint_dir=str(tmp_path / f"fit{k}"))
        state, _ = tr.fit(ds)
        params[k] = [p.detach().clone() for p in state.model.parameters()]
        lines = [tm.parse_line(x)
                 for x in capsys.readouterr().out.splitlines()]
        logged[k] = {int(x["step"]): x["loss"] for x in lines
                     if "loss" in x}
    assert sorted(logged[4]) == [4, 8, 9, 10, 11]
    for step, loss in logged[4].items():
        assert loss == logged[1][step], step
    assert all(torch.equal(a, b) for a, b in zip(params[1], params[4]))
    batch = tuple(torch.as_tensor(a[:B], device="cuda")
                  for a in (ds.x_train, ds.y_train))
    for src, dst in ((4, 1), (1, 4)):
        tr = trainer(dst, seed=5)
        step, st = Checkpointer(str(tmp_path / f"fit{src}")).restore_latest(
            tr.init_state())
        assert step == 11 and st.step == 11
        _, m = tr.train_step(st, batch)
        other = trainer(src, seed=6)
        _, st2 = Checkpointer(str(tmp_path / f"fit{src}")).restore_latest(
            other.init_state())
        _, m2 = other.train_step(st2, batch)
        assert float(m["loss"]) == float(m2["loss"])
        if dst > 1:  # a graph captures over the restored state
            st, mc = tr.train_chunk(st, chunk_of(ds, 4), 4)
            assert np.isfinite(float(mc["loss"])) and st.step == 16


@pytest.mark.cuda
def test_dropout_under_a_graph_equals_eager():
    """Dropout inside a CUDA graph: the masks are functions of device seeds
    that the host writes before each replay, one row a step, from (seed,
    step), so two chunks of k graphed steps equal 2k eager steps bit for
    bit (parameters, optimizer state, the last loss) and each replay runs
    the dropout kernels once a site a step (the embedding's and two a
    block, forward and backward), the warm-up step's included."""
    need_card()
    ds = td.synthetic_lm_dataset(**DATA)
    k, layers, sites = 4, TINY["num_layers"], 1 + 2 * TINY["num_layers"]
    cfg = {**TINY, "dropout_rate": 0.1}

    def dropout_trainer(fused_steps):
        model = tg.GPTLM(tg.GPTConfig.tiny(**cfg), device="cuda")
        model.init_weights(torch.Generator().manual_seed(0))
        return tt.Trainer(model, tt.TrainerConfig(
            batch_size=B, learning_rate=1e-2, warmup_steps=2,
            fused_steps=fused_steps, seed=3), loss_fn=tg.causal_lm_loss)

    graphed = dropout_trainer(k)
    state = graphed.init_state()
    launched = []
    for first in (0, k):
        before = counts()
        state, m = graphed.train_chunk(state, chunk_of(ds, k, first), k)
        torch.cuda.synchronize()
        launched.append({n: c - before[n] for n, c in counts().items()})
    warm = graphed.graph_warmups
    assert warm == tt.GRAPH_WARMUP_STEPS
    for i, steps in enumerate((k + warm, k)):
        assert launched[i] == {
            **{n: layers * steps for n in KERNELS if n.startswith("flash")},
            "dropout_fwd": sites * steps, "dropout_bwd": sites * steps}, i
    eager = dropout_trainer(1)
    ref = eager.init_state()
    for first in (0, k):
        chunk = chunk_of(ds, k, first)
        for i in range(k):
            ref, rm = eager.train_step(ref, tuple(a[i] for a in chunk))
    torch.cuda.synchronize()
    for (name, a), b in zip(state.model.named_parameters(),
                            ref.model.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(state.optimizer.state.values(),
                    ref.optimizer.state.values()):
        assert all(torch.equal(a[key], b[key]) for key in a)
    assert torch.equal(m["loss"], rm["loss"]) and state.step == 2 * k
