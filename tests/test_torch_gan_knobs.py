"""The GAN knobs of the port (``train/gan.py``, ``models/pix2pix.py``)
against the JAX package on the CPU, from the models of the
tests/data/jax_gan_state_nd5_ngf4 fixture (``num_downs`` 5, ``ngf`` 4,
``ndf`` 8, ``n_layers`` 2; 32x32, batch 1): two D+G steps at float64 of the
JAX trainer's ``_gan_batch_impl`` (jitted once a knob) and the port's
``train_batch`` with the same knob, for ``--batched-disc``,
``--concat-free-disc``, ``--shared-gen-fwd``, ``--momentum-dtype
bfloat16`` and ``--flat-opt-state``.

Tolerances, those of tests/test_torch_gan.py's float64 step: losses
within 1e-6 relative; parameters and running means within 1e-6; running
variances within 1e-6 once torch's unbiased update is accounted for
(ROADMAP C1), here from the batch variances each BatchNorm saw in the
port's step, so that updates over different batch sizes (one 2B pass of
``--batched-disc``, then a B pass) and ``--shared-gen-fwd``'s rebuilt
second update are covered.  The bfloat16 first moments equal JAX's but
where the two frameworks' gradients, which differ by about 1e-7 relative
(the JAX models cast their outputs to float32), fall on the two sides of
a bfloat16 rounding boundary: there they differ by one bfloat16 step
(measured: 4 of ~50k elements over two steps); with equal gradients they
are equal bit for bit (tests/test_torch_optim_knobs.py).  The knobs with the same math (``--concat-free-disc``,
``--shared-gen-fwd``, ``--flat-opt-state``) also match the port's default
step within 1e-6 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch.config import GANTrainConfig
from gan_aug_pfa_torch.train.gan import GANTrainer
from gan_aug_pfa_torch.train.optim import make_optimizer
from gan_aug_pfa_tpu import config as jcfg
from gan_aug_pfa_tpu.train.gan import GANState
from gan_aug_pfa_tpu.train.gan import GANTrainer as JaxGANTrainer
from torch_port_helpers import jax_pix2pix_models

SIZE = 32
ARCH = {"num_downs": 5, "ngf": 4, "ndf": 8, "n_layers": 2}
M = 0.9  # flax momentum; torch's 0.1
KNOBS = {
    "batched_disc": dict(batched_disc=True),
    "concat_free_disc": dict(concat_free_disc=True),
    "shared_gen_fwd": dict(shared_gen_fwd=True),
    "momentum_bf16": dict(opt_momentum_dtype="bfloat16"),
    "flat_opt_state": dict(opt_flat_state=True),
}
SAME_MATH = ("concat_free_disc", "shared_gen_fwd", "flat_opt_state")
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "jax_gan_state_nd5_ngf4")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs six test processes on the host's cores at once; two
    threads for this file's CPU work keep them from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    """The committed fixture's JAX generator and discriminator."""
    out = []
    for stem in ("last_generator", "last_discriminator"):
        state = ti.variables_from_msgpack(os.path.join(
            FIXTURE, stem + ".msgpack"))
        out.append({k: jax.tree.map(np.array, state[k])
                    for k in ("params", "batch_stats")})
    return out


@pytest.fixture(scope="module")
def batches():
    rng = np.random.RandomState(7)
    return [tuple(rng.rand(1, SIZE, SIZE, 3) for _ in range(2))
            for _ in range(2)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _jax_steps(variables, batches, knobs):
    cfg = jcfg.GANTrainConfig(target_size=(SIZE, SIZE),
                              compute_dtype="float32", data_parallel=False,
                              **ARCH, **knobs)
    with jax.enable_x64(True):
        trainer = JaxGANTrainer(cfg)
        trainer.generator, trainer.discriminator = jax_pix2pix_models(
            **ARCH, dtype=jnp.float64)
        v64 = [jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
               for v in variables]
        sg = GANState.create(apply_fn=None, params=v64[0]["params"],
                             tx=trainer.tx_g,
                             batch_stats=v64[0]["batch_stats"])
        sd = GANState.create(apply_fn=None, params=v64[1]["params"],
                             tx=trainer.tx_d,
                             batch_stats=v64[1]["batch_stats"])
        step = jax.jit(trainer._gan_batch_impl)
        out = []
        for a, b in batches:
            sg, sd, ld, lg = step(sg, sd, a, b)
            out.append(jax.tree.map(np.asarray, {
                "g": {"params": sg.params, "batch_stats": sg.batch_stats},
                "d": {"params": sd.params, "batch_stats": sd.batch_stats},
                "opt": (sg.opt_state, sd.opt_state), "loss": (ld, lg)}))
    return out


class _BatchVariances:
    """The biased batch variance and element count per channel of every
    train-mode BatchNorm call, in call order, by module name."""

    def __init__(self, model):
        self.seen = {}
        self.hooks = [m.register_forward_pre_hook(self._hook(name))
                      for name, m in model.named_modules()
                      if isinstance(m, torch.nn.BatchNorm2d)]

    def _hook(self, name):
        def hook(module, inputs):
            if module.training:
                x = inputs[0].detach()
                self.seen.setdefault(name, []).append((
                    x.var(dim=(0, 2, 3), unbiased=False),
                    x.numel() // x.shape[1]))
        return hook


def _port_steps(variables, batches, knobs):
    cfg = GANTrainConfig(target_size=(SIZE, SIZE), compute_dtype="float32",
                         **ARCH, **knobs)
    port = GANTrainer(cfg, "cpu")
    port.generator.double()
    port.discriminator.double()
    port.load_state_dicts(
        ti.generator_state_dict_from_jax(variables[0], dtype=np.float64),
        ti.discriminator_state_dict_from_jax(variables[1], dtype=np.float64))
    # The optimizers over the float64 parameters (flat: views of one
    # float64 buffer).
    opt_knobs = dict(b1=cfg.beta1, mu_dtype=cfg.opt_momentum_dtype,
                     flat_state=cfg.opt_flat_state)
    port.opt_g = make_optimizer("adam", port.generator.parameters(),
                                cfg.learning_rate_g, **opt_knobs)
    port.opt_d = make_optimizer("adam", port.discriminator.parameters(),
                                cfg.learning_rate_d, **opt_knobs)
    start = {"g": {k: v.clone() for k, v in
                   port.generator.state_dict().items()},
             "d": {k: v.clone() for k, v in
                   port.discriminator.state_dict().items()}}
    out = []
    for a, b in batches:
        seen = {"g": _BatchVariances(port.generator),
                "d": _BatchVariances(port.discriminator)}
        ld, lg = port.train_batch(_nchw(a), _nchw(b))
        for s in seen.values():
            for h in s.hooks:
                h.remove()
        out.append({
            "g": {k: v.clone() for k, v in
                  port.generator.state_dict().items()},
            "d": {k: v.clone() for k, v in
                  port.discriminator.state_dict().items()},
            "seen": {k: s.seen for k, s in seen.items()},
            "opt": (port.opt_g, port.opt_d),
            "names": tuple([n for n, _ in m.named_parameters()]
                           for m in (port.generator, port.discriminator)),
            "loss": (float(ld), float(lg))})
    return start, out


@pytest.fixture(scope="module")
def runs(variables, batches):
    cache = {}

    def get(knob):
        if knob not in cache:
            knobs = KNOBS.get(knob, {})
            cache[knob] = {"port": _port_steps(variables, batches, knobs)}
            if knob != "default":
                cache[knob]["jax"] = _jax_steps(variables, batches, knobs)
        return cache[knob]
    return get


def _jax_sd(step, net):
    convert = (ti.generator_state_dict_from_jax if net == "g"
               else ti.discriminator_state_dict_from_jax)
    return convert(step[net], np.float64)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_losses_match_jax(runs, knob):
    r = runs(knob)
    for j, p in zip(r["jax"], r["port"][1]):
        assert p["loss"][0] == pytest.approx(float(j["loss"][0]), rel=1e-6)
        assert p["loss"][1] == pytest.approx(float(j["loss"][1]), rel=1e-6)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_parameters_match_jax(runs, knob):
    """Both models' parameters after each step; each moved."""
    r = runs(knob)
    start, steps = r["port"]
    for j, p in zip(r["jax"], steps):
        for net in ("g", "d"):
            want = _jax_sd(j, net)
            for k, v in p[net].items():
                if "running" in k or "num_batches" in k:
                    continue
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           rtol=0, atol=1e-6, err_msg=k)
                assert float((v - start[net][k]).abs().max()) > 1e-5, k


def _updates(knob, net):
    """BatchNorm updates of one step, in order, as (call index) into the
    calls the hooks saw: G's second update under --shared-gen-fwd repeats
    the first forward's batch."""
    if net == "g":
        return [0, 0] if knob == "shared_gen_fwd" else [0, 1]
    return [0, 1] if knob == "batched_disc" else [0, 1, 2]


@pytest.mark.parametrize("knob", list(KNOBS))
def test_batchnorm_statistics_match_jax(runs, knob):
    """After step 1: running means within 1e-6, num_batches_tracked the
    reference's count (2 in G, 3 in D; 2 in D under --batched-disc), and
    running variances within 1e-6 of JAX's plus torch's unbiased
    correction of each update, sum_i M^(K-i) (1-M) bv_i / (N_i - 1)."""
    r = runs(knob)
    start, steps = r["port"]
    got, want = steps[0], r["jax"][0]
    for net in ("g", "d"):
        jsd = _jax_sd(want, net)
        updates = _updates(knob, net)
        for name, calls in got["seen"][net].items():
            mean, var = name + ".running_mean", name + ".running_var"
            assert int(got[net][name + ".num_batches_tracked"]) == len(
                updates), name
            np.testing.assert_allclose(got[net][mean], jsd[mean], rtol=0,
                                       atol=1e-6, err_msg=mean)
            k = len(updates)
            corr = sum(M ** (k - 1 - i) * (1 - M) * calls[c][0]
                       / (calls[c][1] - 1) for i, c in enumerate(updates))
            np.testing.assert_allclose(got[net][var], jsd[var] + corr,
                                       rtol=1e-6, atol=1e-9, err_msg=var)


def test_bf16_moments_equal_jax(runs):
    r = runs("momentum_bf16")
    last, jlast = r["port"][1][-1], r["jax"][-1]
    for i, net in enumerate(("g", "d")):
        opt = last["opt"][i]
        adam = jlast["opt"][i].inner_state[1]
        want = (ti.generator_state_dict_from_jax if net == "g"
                else ti.discriminator_state_dict_from_jax)(
            {"params": adam.mu, "batch_stats": jlast[net]["batch_stats"]})
        names = last["names"][i]
        assert len(opt.exp_avg) == len(names)
        differ = total = 0
        for n, m in zip(names, opt.exp_avg):
            assert m.dtype == torch.bfloat16
            np.testing.assert_allclose(m.float(), want[n], rtol=2.0 ** -7,
                                       atol=0, err_msg=n)
            differ += int((m.float() != want[n]).sum())
            total += m.numel()
        assert differ <= total // 1000, (differ, total)


@pytest.mark.parametrize("knob", SAME_MATH)
def test_same_math_knob_matches_the_default_step(runs, knob):
    base, r = runs("default")["port"][1], runs(knob)["port"][1]
    for b, p in zip(base, r):
        assert p["loss"][0] == pytest.approx(b["loss"][0], rel=1e-6)
        assert p["loss"][1] == pytest.approx(b["loss"][1], rel=1e-6)
        for net in ("g", "d"):
            for k, v in p[net].items():
                if "num_batches" in k:
                    assert torch.equal(v, b[net][k]), k
                    continue
                np.testing.assert_allclose(v.numpy(), b[net][k].numpy(),
                                           rtol=1e-6, atol=1e-9, err_msg=k)
