"""The reference's training oracles for the port's train tests
(test_torch_train_moe.py, test_torch_train_recurrent.py): its params, its
loss, logits and ``jax.grad`` in one jitted computation, and one jitted
``make_train_step``, each on the CPU and returned as numpy. The MoE
router's top-k expert ids of each computation are recorded as it runs
(a debug callback beside ``lax.top_k``), so that the port can be driven
along the very same routes (:func:`force_routes`).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.models.api import lm_loss as jlm_loss
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.models import layers as TL
from repro_torch.tree import leaves


class _RecordingLax:
    """``jax.lax`` with a ``top_k`` that reports its ids to ``out``."""

    def __init__(self, out: list):
        self._out = out

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def top_k(self, x, k):
        vals, idx = jax.lax.top_k(x, k)
        jax.debug.callback(lambda i: self._out.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx


@contextlib.contextmanager
def recording_routes():
    """Within: every MoE layer the reference runs appends its expert ids
    [N, top_k] to the yielded list, in layer order."""
    out, saved = [], JL.lax
    JL.lax = _RecordingLax(out)
    try:
        yield out
    finally:
        JL.lax = saved
    jax.effects_barrier()
    out[:] = [r.reshape(-1, r.shape[-1]) for r in out]


def init_params(cfg, max_seq: int) -> dict:
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: jget_model(cfg).init(k, cfg, max_seq=max_seq))(
        jax.random.PRNGKey(0)))


def loss_logits_grads(cfg, params, tokens) -> dict:
    """The reference's loss, logits [B, T, V] and gradients of its params
    (one jitted computation) and the routes it took."""
    jm = jget_model(cfg)
    batch = {"tokens": jnp.asarray(tokens)}

    def f(p):
        logits = jm.forward_train(p, batch, cfg)
        return jlm_loss(logits, batch, cfg), logits

    with recording_routes() as routes:
        (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree.map(jnp.asarray, params))
        jax.block_until_ready(grads)
    return dict(loss=float(loss), logits=np.asarray(logits),
                grads=jax.tree.map(np.asarray, grads), routes=routes)


def train_step(cfg, params, tokens, **tc) -> dict:
    """One jitted reference ``make_train_step`` from ``params`` and fresh
    moments: the new state, the metrics, the routes and the step-0 lr."""
    tcfg = jts.TrainConfig(**tc)
    jp = jax.tree.map(jnp.asarray, params)
    state = {"params": jp, "opt": jadamw.init(jp, tcfg.adamw),
             "step": jnp.zeros((), jnp.int32)}
    with recording_routes() as routes:
        new, metrics = jax.jit(jts.make_train_step(cfg, tcfg))(
            state, {"tokens": jnp.asarray(tokens)})
        jax.block_until_ready(new)
    lr = float(jadamw.schedule(jadamw.effective_lr_config(
        tcfg.adamw, cfg.d_model), 0))
    return dict(state=jax.tree.map(np.asarray, new), routes=routes, lr=lr,
                metrics={k: np.asarray(v) for k, v in metrics.items()})


@contextlib.contextmanager
def force_routes(routes: list):
    """Within: the port's router selects the reference's experts ``routes``
    (one [N, top_k] array per MoE layer, cycled in layer order) with its
    own gate probabilities at them. Yields a list that receives, per
    call, the port's own choice [N, top_k] and the gap between its k-th
    and (k+1)-th probabilities [N]. Calls on the ``meta`` device (a
    serving engine's shape census) take the port's own choice and are not
    counted."""
    saved, own, calls = TL._top_k, [], [0]

    def top_k(probs, k):
        if probs.device.type == "meta":  # a serving engine's shape census
            return saved(probs, k)
        vals, idx = saved(probs, k + 1)
        own.append((idx[..., :k], (vals[..., k - 1] - vals[..., k]).detach()))
        ids = torch.from_numpy(routes[calls[0] % len(routes)].astype(np.int64))
        calls[0] += 1
        return torch.gather(probs, -1, ids), ids

    TL._top_k = top_k
    try:
        yield own
    finally:
        TL._top_k = saved


def assert_grads_close(got, want, rel: float) -> None:
    """Every leaf's gradient within ``rel`` of the reference's, normwise:
    ||got - want|| <= rel * ||want||."""
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves(got)) == len(flat)
    for a, (path, b) in zip(leaves(got), flat):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        err = np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)
        assert err <= rel, (jax.tree_util.keystr(path), err)


def assert_step_close(new, metrics, want: dict, loss_atol: float) -> None:
    """One port step against the reference's, as test_torch_train.py's
    llama step: loss within ``loss_atol``, grad norm within 2e-3; every
    param within 2·lr + 1e-6 (AdamW's first step moves a param by
    lr·sign(g), so a near-zero gradient whose sign the two frameworks
    round differently moves it 2·lr apart) and within 1e-6 for all but
    1% of them."""
    assert abs(metrics["loss"].item() - float(want["metrics"]["loss"])) \
        < loss_atol
    assert abs(metrics["grad_norm"].item()
               / float(want["metrics"]["grad_norm"]) - 1) < 2e-3
    assert int(new["step"]) == 1
    n_off = n_all = 0
    for a, b in zip(leaves(new["params"]),
                    jax.tree.leaves(want["state"]["params"])):
        d = np.abs(a.numpy() - b)
        assert d.max() <= 2 * want["lr"] + 1e-6
        n_off += int((d > 1e-6).sum())
        n_all += d.size
    assert n_off <= 0.01 * n_all
