"""Dropout whose masks live on the device (kernels/dropout.py,
models/layers.py, train/trainer.py), on the CPU.

The plain version, which every CPU mask comes from and which the card's
kernels (csrc/dropout.cu) equal bit for bit (tests/test_torch_kernels.py,
chip_smoke.py phase 12), is held here against an independent Philox4x32-10
written with numpy uint32 arithmetic and against Random123's known-answer
vectors. The masks are functions of (seed, step) in the Trainer, so a
resumed fit and a fused-steps fit draw the masks of the uninterrupted
per-step fit; a block under remat recomputes under its forward's context
axis, whatever thread runs the backward. The JAX package draws its masks
with jax.random, so the two packages' masks differ and are held by
statistics (test_torch_bert.py, test_torch_train.py,
test_torch_vision.py).
"""

import threading

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.kernels import dropout as kd
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.models import layers as tlayers
from kubeflow_tpu_torch.train import data as td
from kubeflow_tpu_torch.train import metrics as tm
from kubeflow_tpu_torch.train import trainer as tt

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            mlp_dim=64, max_len=16, dropout_rate=0.1, attention_block=8)
DATA = dict(n_train=40, n_test=8, seq_len=16, vocab_size=64)

# Random123's known-answer vectors for philox4x32 with 10 rounds:
# (counter, key, output)
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


def numpy_philox(ctr: np.ndarray, key) -> np.ndarray:
    """Philox4x32-10 in numpy uint32/uint64 arithmetic: ctr (N, 4) uint32,
    key (k0, k1); returns (N, 4) uint32."""
    c = [ctr[:, j].astype(np.uint32) for j in range(4)]
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    for r in range(10):
        if r:
            k0 = np.uint32((int(k0) + 0x9E3779B9) & 0xFFFFFFFF)
            k1 = np.uint32((int(k1) + 0xBB67AE85) & 0xFFFFFFFF)
        p0 = c[0].astype(np.uint64) * m0
        p1 = c[2].astype(np.uint64) * m1
        hi0, lo0 = (p0 >> np.uint64(32)).astype(np.uint32), p0.astype(
            np.uint32)
        hi1, lo1 = (p1 >> np.uint64(32)).astype(np.uint32), p1.astype(
            np.uint32)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return np.stack(c, axis=1)


def test_plain_philox_known_answers():
    for ctr, key, want in KAT:
        got = kd.philox4x32_10(*(torch.tensor([v]) for v in ctr),
                               *(torch.tensor(v) for v in key))
        assert [int(w) for w in got] == list(want)
        assert numpy_philox(np.array([ctr], np.uint32), key)[0].tolist() \
            == list(want)


@pytest.mark.parametrize("seed,site,n", [(0, 0, 37), (2**61 + 12345, 2, 4099),
                                         (0xDEADBEEF12345678 >> 2, 1, 1000)])
def test_plain_draws_equal_independent_numpy_philox(seed, site, n):
    """Element i's draw is word i % 4 of Philox(counter (i // 4 split in
    32-bit halves, site, 0), key (seed's halves)); counters past 2^32
    carry into the second word."""
    got = kd.dropout_draws(torch.tensor(seed), site, n).numpy()
    g = np.arange((n + 3) // 4, dtype=np.uint64)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    ctr = np.stack([g & np.uint64(0xFFFFFFFF), g >> np.uint64(32),
                    np.full_like(g, site), np.zeros_like(g)],
                   axis=1).astype(np.uint32)
    np.testing.assert_array_equal(got, numpy_philox(ctr, key).reshape(-1)[:n])
    # a counter past 2^32 (element 2^34 + 4 of a huge tensor): the second
    # counter word
    big = torch.tensor([2**32 + 1])
    hi = kd.philox4x32_10(big & 0xFFFFFFFF, big >> 32, torch.tensor([site]),
                          torch.tensor([0]), torch.tensor(key[0]),
                          torch.tensor(key[1]))
    want = numpy_philox(np.array([[1, 1, site, 0]], np.uint32), key)[0]
    assert [int(w) for w in hi] == want.tolist()


def test_plain_dropout_function():
    """Kept elements are x * float32(1 / keep) rounded to x's dtype, the
    others 0; the kept share is within 4 sigma of 1 - rate; another seed
    or site draws another mask; the backward is the forward's function of
    the grad; rate 1 gives zeros (flax's nn.Dropout)."""
    n, rate = 200_003, 0.1
    x = torch.randn(n, generator=torch.Generator().manual_seed(0))
    seed = torch.tensor(99)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        y = kd.dropout_plain(xd, seed, rate, site=1)
        keep = kd.dropout_mask(seed, 1, rate, xd.shape)
        assert y.dtype == dtype
        assert torch.equal(y[~keep], torch.zeros_like(y[~keep]))
        assert torch.equal(y[keep], (xd[keep].float() * np.float32(1 / 0.9))
                           .to(dtype))
    share = keep.float().mean().item()
    assert abs(share - 0.9) < 4 * (rate * (1 - rate) / n) ** 0.5, share
    assert not torch.equal(keep, kd.dropout_mask(seed, 2, rate, (n,)))
    assert not torch.equal(keep, kd.dropout_mask(torch.tensor(98), 1, rate,
                                                 (n,)))
    xg = x[:1000].clone().requires_grad_(True)
    out = tlayers.dropout(xg, rate, seed, site=3)
    g = torch.randn(1000)
    out.backward(g)
    assert torch.equal(xg.grad, kd.dropout_plain(g, seed, rate, 3))
    assert torch.equal(tlayers.dropout(x, 1.0, seed), torch.zeros_like(x))
    assert tlayers.dropout(x, 0.0, seed) is x
    assert kd.keep_threshold(0.1) == int(np.ceil(0.9 * 2**32))
    with pytest.raises(ValueError, match="not CUDA"):
        kd.dropout_fwd(x, seed, rate)
    with pytest.raises(ValueError, match=r"not in \(0, 1\)"):
        kd.dropout_plain(x, seed, 1.0)


def test_dropout_seeds_are_taken_in_order():
    seeds = tlayers.DropoutSeeds(torch.arange(10))
    a = tlayers.block_seeds(3, True, 0.1, seeds, torch.device("cpu"))
    b = tlayers.block_seeds(2, True, 0.1, seeds, torch.device("cpu"))
    assert [int(s) for s in a + b] == [0, 1, 2, 3, 4]
    assert tlayers.block_seeds(4, False, 0.1, seeds, torch.device("cpu")) \
        == [None] * 4
    with pytest.raises(ValueError, match="more than 10 dropout seeds"):
        tlayers.block_seeds(6, True, 0.1, seeds, torch.device("cpu"))


def trainer(**cfg):
    model = tg.GPTLM(tg.GPTConfig.tiny(**TINY), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    return tt.Trainer(model, tt.TrainerConfig(
        **{"batch_size": 4, "learning_rate": 1e-2, "seed": 5, **cfg}),
        loss_fn=tg.causal_lm_loss, eval_metrics_fn=tg.causal_lm_eval_metrics)


def test_step_masks_are_a_function_of_seed_and_step():
    """A step's seeds depend on (TrainerConfig.seed, step) only: two
    trainers agree at each step, steps differ, seeds differ; the same batch
    at two steps draws two masks (two losses)."""
    a, b, c = trainer(), trainer(), trainer(seed=6)
    assert torch.equal(a._step_seeds(3), b._step_seeds(3))
    assert not torch.equal(a._step_seeds(3), a._step_seeds(4))
    assert not torch.equal(a._step_seeds(3), c._step_seeds(3))
    assert a._graph_seeds(a.init_state(), 2).shape == (
        2, tlayers.DROPOUT_SEEDS_PER_STEP)
    ds = td.synthetic_lm_dataset(**DATA)
    batch = (ds.x_train[:4], ds.y_train[:4])
    state = a.init_state()
    with torch.no_grad():
        first = tt.Trainer._apply(a, state.model,
                                  torch.from_numpy(batch[0]).long(),
                                  tlayers.DropoutSeeds(a._step_seeds(0)),
                                  True)
        again = tt.Trainer._apply(a, state.model,
                                  torch.from_numpy(batch[0]).long(),
                                  tlayers.DropoutSeeds(a._step_seeds(0)),
                                  True)
        other = tt.Trainer._apply(a, state.model,
                                  torch.from_numpy(batch[0]).long(),
                                  tlayers.DropoutSeeds(a._step_seeds(1)),
                                  True)
    assert torch.equal(first, again) and not torch.equal(first, other)


def fit_losses(tmp_path, steps, capsys, **kw):
    tr = trainer(steps=steps, log_every_steps=1, checkpoint_dir=str(tmp_path),
                 checkpoint_every_steps=10, **kw)
    state, _ = tr.fit(td.synthetic_lm_dataset(**DATA))  # 10 steps an epoch
    lines = [tm.parse_line(x) for x in capsys.readouterr().out.splitlines()]
    return state, {int(x["step"]): x["loss"] for x in lines if "loss" in x}


def test_resumed_and_fused_fits_draw_the_same_masks(tmp_path, capsys):
    """With dropout 0.1: a fit stopped at the epoch boundary (step 10) and
    resumed by a new trainer logs the uninterrupted fit's losses from step
    11 on, and a fused_steps=4 fit (on the CPU, chunks of per-step
    train_steps) ends with the per-step fit's parameters, bit for bit."""
    whole_state, whole = fit_losses(tmp_path / "a", 20, capsys)
    fit_losses(tmp_path / "b", 10, capsys)
    state, resumed = fit_losses(tmp_path / "b", 20, capsys)
    assert sorted(resumed) == list(range(11, 21))
    for step, loss in resumed.items():
        assert loss == whole[step], step
    fused_state, _ = fit_losses(tmp_path / "c", 20, capsys, fused_steps=4)
    want = whole_state.model.state_dict()
    for sd in (state.model.state_dict(), fused_state.model.state_dict()):
        for k, v in sd.items():
            assert torch.equal(v, want[k]), k


def test_remat_step_equals_plain_step():
    """One Trainer step under dropout with remat equals the step without:
    the recomputed blocks redraw their masks from their seeds."""
    ds = td.synthetic_lm_dataset(**DATA)
    batch = (ds.x_train[:4], ds.y_train[:4])
    out = []
    for remat in (False, True):
        tr = trainer()
        tr.model.cfg = tg.GPTConfig.tiny(**TINY, remat=remat)
        state, m = tr.train_step(tr.init_state(), batch)
        out.append((float(m["loss"]), state.model.state_dict()))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], v, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_remat_recomputes_under_the_forwards_context_axis(device):
    """A block under remat recomputes with the context axis its forward
    saw, also where the backward runs on a thread that sees none of the
    caller's context variables: on the card autograd's device thread, on
    the CPU a fresh thread (whose context is empty)."""
    from kubeflow_tpu_torch.parallel.mesh import ContextAxis, \
        context_axis, current_context_axis

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: autograd's device thread")
    seen, errors = [], []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3, device=device))

        def forward(self, x):
            seen.append(current_context_axis())
            return (x * self.w).sin()

    def backward(loss):
        try:
            loss.backward()
        except Exception as e:  # reported below, on the test's thread
            errors.append(e)

    axis = ContextAxis(1, 2, None, (0, 1))
    x = torch.ones(3, device=device, requires_grad=True)
    with context_axis(axis):
        loss = tlayers.remat(Probe(), x).sum()
    if device == "cuda":
        backward(loss)
    else:
        t = threading.Thread(target=backward, args=(loss,))
        t.start()
        t.join()
    assert not errors, errors
    assert seen == [axis, axis]
    torch.testing.assert_close(x.grad.cpu(), torch.ones(3).cos())
