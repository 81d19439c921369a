"""Step-by-step parity of one float64 Siamese epoch, the port against the
JAX package, on the CPU (ROADMAP §C15).

The port runs with the JAX package's two float32 islands copied in: the
upsample's float32-rounded interpolation weights
(``gan_aug_pfa_tpu/ops/resize.py`` ``_upsample_matrix``) and the model's
float32 logits (``models/siamese_unet.py`` ``out.astype(jnp.float32)``).
Both trainers start from one init and take the 11 pairs of
``tests/test_torch_parallel.py`` in one order at batch 4.  After each step
it prints how far apart the loss, the gradients (relative to each
tensor's largest; all of them, and the weights'), the parameters (in
learning-rate steps) and the running means are.

Before step 1 it splits the step's gradient difference in two: the
logits' gradient (the cotangent that each framework's FocalDice hands the
model: at float64, and at float32, where the logits' cast rounds it), and
the model's backward given one and the same cotangent, each framework's
backward run on the other's.  Needs JAX (about 2 minutes):

    JAX_PLATFORMS=cpu python tools/c15_step_parity.py
"""

import copy
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_parallel as tp  # noqa: E402
from gan_aug_pfa_torch.data.transforms import normalize as torch_normalize  # noqa: E402,E501
from gan_aug_pfa_torch.models import siamese_unet  # noqa: E402
from gan_aug_pfa_tpu import config as jcfg  # noqa: E402
from gan_aug_pfa_tpu import interop as ji  # noqa: E402
from gan_aug_pfa_tpu import losses as jlosses  # noqa: E402
from gan_aug_pfa_tpu.data.transforms import normalize  # noqa: E402
from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxModel  # noqa: E402,E501
from gan_aug_pfa_tpu.train.siamese import SiameseTrainer as JaxTrainer  # noqa: E402,E501
from gan_aug_pfa_tpu.train.siamese import TrainState  # noqa: E402


def jax_upsample_matrix(n):
    """The JAX package's (2n, n) align_corners upsample matrix
    (``ops/resize.py`` ``_upsample_matrix``): float32 weights, as
    float64."""
    src = np.arange(2 * n) * (n - 1) / (2 * n - 1)
    lo = np.floor(src).astype(np.int64)
    w = (src - lo).astype(np.float32)
    m = np.zeros((2 * n, n), np.float32)
    np.add.at(m, (np.arange(2 * n), lo), 1 - w)
    np.add.at(m, (np.arange(2 * n), np.minimum(lo + 1, n - 1)), w)
    return torch.from_numpy(m.astype(np.float64))


def upsample_jax_weights(x):
    """``upsample2x_align_corners`` on NCHW as the JAX package computes
    it: two matmuls with the float32-rounded weights."""
    mh, mw = (jax_upsample_matrix(n).to(x.dtype) for n in x.shape[-2:])
    return torch.einsum("pw,ncow->ncop", mw,
                        torch.einsum("oh,nchw->ncow", mh, x))


class Float32Is64:  # the JAX FocalDice at float64
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def torch_layout(params, stats):
    return {k: torch.from_numpy(np.array(v, np.float64)) for k, v in
            ji.siamese_to_torch(jax.tree.map(np.asarray, {
                "params": params, "batch_stats": stats})).items()}


def worst(diffs, n=3):
    return ", ".join(f"{k} {v:.3g}" for v, k in sorted(
        ((v, k) for k, v in diffs.items()), reverse=True)[:n])


def rel(a, b):
    """max|a - b| / max|b|."""
    return float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)


def port_backward(trainer, model, cache, idx, cotangent=None):
    """A train-mode forward of a copy of ``model`` on the cache rows
    ``idx`` and its backward: from the port's FocalDice (``cotangent``
    None) or from ``cotangent`` given at the float32 logits.  Returns the
    float32 logits (NCHW), their gradient and the parameters'."""
    model = copy.deepcopy(model).train()
    x1, x2 = (torch_normalize(a[idx]) for a in (cache.img1, cache.img2))
    logits = FORWARD(model, x1, x2).float()
    logits.retain_grad()
    if cotangent is None:
        trainer.loss(logits.double(), cache.labels[idx]).backward()
    else:
        logits.backward(cotangent)
    return logits.detach(), logits.grad, {
        k: p.grad.clone() for k, p in model.named_parameters()}


def localize_step_one(trainer, cache, state, nhwc, labels, idx, jt):
    """Step 1's gradient difference, split between the logits' float32
    gradient and the model's backward (module docstring)."""
    def loss_fn(logits, idx):
        lab = jnp.take(labels, idx, axis=0).astype(jnp.float32)[..., None]
        return jt._loss(logits, lab)

    def apply(params, idx):
        img1, img2 = (normalize(jnp.take(a, idx, axis=0)) for a in nhwc)
        return state.apply_fn(
            {"params": params, "batch_stats": state.batch_stats},
            img1, img2, train=True, mutable=["batch_stats"])[0]

    @jax.jit
    def jax_side(idx):
        logits = apply(state.params, idx)
        return (logits, jax.grad(loss_fn)(logits, idx),
                jax.grad(loss_fn)(logits.astype(jnp.float64), idx))

    @jax.jit
    def jax_pull(idx, cotangent):
        _, pull = jax.vjp(lambda p: apply(p, idx), state.params)
        return pull(cotangent.astype(jnp.float32))[0]

    nchw = (lambda a: torch.from_numpy(
        np.array(a, np.float64)).permute(0, 3, 1, 2))
    j_logits, j_dlogits, j_d64 = map(nchw, jax_side(jnp.asarray(idx)))
    x64 = j_logits.contiguous().requires_grad_()
    trainer.loss(x64, cache.labels[torch.from_numpy(idx)]).backward()
    p_d64 = x64.grad
    p_logits, p_dlogits, p_grads = port_backward(
        trainer, trainer.model, cache, torch.from_numpy(idx))
    _, _, p_on_j = port_backward(trainer, trainer.model, cache,
                                 torch.from_numpy(idx), j_dlogits.float())
    j_grads = torch_layout(jax_pull(jnp.asarray(idx), jnp.asarray(
        j_dlogits.permute(0, 2, 3, 1).numpy())), state.batch_stats)
    j_on_p = torch_layout(jax_pull(jnp.asarray(idx), jnp.asarray(
        p_dlogits.double().permute(0, 2, 3, 1).numpy())), state.batch_stats)
    weights = [k for k, _ in trainer.model.named_parameters()
               if k.endswith(".weight")]
    flips = (p_dlogits.double() != j_dlogits)
    ulp = float(((p_dlogits.double() - j_dlogits).abs()
                 / torch.finfo(torch.float32).eps
                 / j_dlogits.abs().clamp_min(1e-30))[flips].max()) \
        if flips.any() else 0.0

    def worst_of(a, b):
        diffs = {k: rel(a[k], b[k]) for k in weights}
        return max(diffs.values()), worst(diffs, 1)

    def rounded(d64):  # float64 cotangent, rounded to nearest float32
        return d64.float().double()

    print(f"step 1 localized: float32 logits max|d| "
          f"{float((p_logits.double() - j_logits).abs().max()):.3g} "
          f"({int((p_logits.double() != j_logits).sum())} of "
          f"{p_logits.numel()} differ); their gradient at float64 "
          f"{rel(p_d64, j_d64):.3g} of max apart, rounded to float32 "
          f"{int((rounded(p_d64) != rounded(j_d64)).sum())} elements apart;"
          f" at float32 (through the cast) {int(flips.sum())} of "
          f"{flips.numel()} elements apart, by at most {ulp:.3g} float32 "
          f"eps of the element ({rel(p_dlogits.double(), j_dlogits):.3g} "
          f"of max); the port's equal to its float64 one rounded to "
          f"nearest: {torch.equal(p_dlogits.double(), rounded(p_d64))}, "
          f"JAX's: {int((j_dlogits != rounded(j_d64)).sum())} elements "
          f"differ", flush=True)
    print("  weights' gradients, of each tensor's max: port vs JAX %.3g "
          "(%s); each backward given JAX's logits gradient %.3g (%s); "
          "given the port's %.3g (%s)" % (
              *worst_of(p_grads, j_grads), *worst_of(p_on_j, j_grads),
              *worst_of(p_grads, j_on_p)), flush=True)


def main():
    global FORWARD
    torch.manual_seed(0)
    siamese_unet.upsample2x_align_corners = upsample_jax_weights
    forward = FORWARD = siamese_unet.SiameseUNet.forward
    siamese_unet.SiameseUNet.forward = (
        lambda self, *x: forward(self, *x).float().double())
    trainer = tp._siamese(None)
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    lr = trainer.config.learning_rate
    cache = tp._cache()
    perm = np.random.RandomState(tp.EPOCH_SEED).permutation(tp.N_PAIRS)
    batches = [perm[s:s + tp.BS] for s in range(0, tp.N_PAIRS, tp.BS)]

    jlosses.jnp = Float32Is64()
    jax.config.update("jax_enable_x64", True)
    jt = JaxTrainer(jcfg.SiameseTrainConfig(batch_size=tp.BS,
                                            compute_dtype="float32"))
    v64 = jax.tree.map(lambda a: jnp.asarray(a, np.float64),
                       ji.siamese_from_torch(
                           {k: v.numpy() for k, v in init.items()}))
    state = TrainState.create(apply_fn=JaxModel(3, 1, dtype=np.float64).apply,
                              params=v64["params"], tx=jt.tx,
                              batch_stats=v64["batch_stats"])
    nhwc = [jnp.asarray(a.permute(0, 2, 3, 1).numpy())
            for a in (cache.img1, cache.img2)]
    labels = jnp.asarray(cache.labels.numpy().astype(np.int32))

    @jax.jit
    def jax_grads(state, idx):
        img1, img2 = (normalize(jnp.take(a, idx, axis=0)) for a in nhwc)
        lab = jnp.take(labels, idx, axis=0).astype(jnp.float32)[..., None]

        def loss_fn(params):
            logits, _ = state.apply_fn(
                {"params": params, "batch_stats": state.batch_stats},
                img1, img2, train=True, mutable=["batch_stats"])
            return jt._loss(logits, lab)

        return jax.grad(loss_fn)(state.params)

    localize_step_one(trainer, cache, state, nhwc, labels, batches[0], jt)
    for step, idx in enumerate(batches, 1):
        grads = torch_layout(jax_grads(state, jnp.asarray(idx)),
                             state.batch_stats)
        state, jloss = jt._train_step(state, *nhwc, labels,
                                      jnp.asarray(idx, jnp.int32),
                                      jax.random.PRNGKey(0))
        loss = float(trainer.train_step(cache, torch.from_numpy(idx)))
        want = torch_layout(state.params, state.batch_stats)
        got = trainer.model.state_dict()
        named = dict(trainer.model.named_parameters())
        gdiff = {k: float((named[k].grad - grads[k]).abs().max())
                 / (float(grads[k].abs().max()) or 1.0) for k in named}
        wdiff = {k: v for k, v in gdiff.items() if k.endswith(".weight")}
        pdiff = {k: float((got[k] - want[k]).abs().max()) / lr
                 for k in named}
        mdiff = {k: float((got[k] - want[k]).abs().max())
                 / float(want[k].abs().max())
                 for k in want if k.endswith("running_mean")}
        print(f"step {step} (batch {len(idx)}): loss rel "
              f"{abs(loss / float(jloss) - 1):.3g}; gradients max "
              f"{max(gdiff.values()):.3g} of each tensor's max ({worst(gdiff)})"
              f", weights' {max(wdiff.values()):.3g} ({worst(wdiff, 1)})"
              f"; parameters max {max(pdiff.values()):.3g} lr "
              f"({worst(pdiff)}); running means max "
              f"{max(mdiff.values()):.3g} of max ({worst(mdiff, 1)})",
              flush=True)


if __name__ == "__main__":
    main()
