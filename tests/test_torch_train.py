"""The port's MST++ training (``models/train.py``, ``models/data.py`` and the
differentiable forward of ``models/mst_plus_plus.py``) against the JAX
package's, on the CPU.

One JAX jit of the stage-1 train step (and one of its gradient) at
2 x 32x32 is shared by the module. The JAX side starts from
``init_state(MSTPlusPlus(stage=1), ..., seed=0)``; the port's model gets
those params through ``from_jax_params``, and the JAX gradient and Adam
moments go through it too (it takes any tree shaped like the params).
Patches come from ``sample_patches`` on JAX ``synthetic_scenes``, so both
sides see the same inputs.

Bars: the schedule within 1e-7 of optax at every count; one step's loss
within 1e-5 relative and each gradient within 1e-4 of its tensor's
max |g|; five steps' losses within 1e-4 relative; parameters within the
Adam bound: an element whose gradient is at noise level may move the other
way on the other side, about lr in each direction, so the max is held to
2 x the sum of the rates and the RMS to 1e-4 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from animal_vision_tpu.models import data as jdata
from animal_vision_tpu.models import eval as jeval
from animal_vision_tpu.models import train as jtrain
from animal_vision_tpu.models.mst_plus_plus import MSTPlusPlus as JMSTPlusPlus
from animal_vision_tpu.models.mst_plus_plus import no_fused_ffn
from animal_vision_tpu_torch.models import data, train
from animal_vision_tpu_torch.models import eval as meval
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, from_jax_params

LR, TOTAL, WARMUP = 2e-3, 20, 2
BATCH, PATCH = 2, 32
LOSS_REL = 1e-5
TRAIL_REL = 1e-4
GRAD_REL = 1e-4
RMS_OF_BOUND = 1e-4
SCENE_TOL = 1e-6  # bilinear taps: cv2's float64 weights rounded once against jax.image.resize's float32; 4.2e-7 seen


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: module, optimizer, initial state, the jitted step and
    the jitted (loss, pred), grad of ``loss_fn``, the scenes and patches."""
    module = JMSTPlusPlus(stage=1)
    opt = jtrain.make_optimizer(lr=LR, total_steps=TOTAL, warmup=WARMUP)
    state = jtrain.init_state(module, opt, sample_shape=(1, PATCH, PATCH, 3), seed=0)
    step = jax.jit(jtrain.make_train_step(module, opt, loss="mrae"))
    grad = jax.jit(jax.value_and_grad(jtrain.loss_fn, has_aux=True), static_argnums=(1, 4))
    scenes = jtrain.synthetic_scenes(4, 64, 64, 0)
    rng = np.random.default_rng(1)
    batches = [jtrain.sample_patches(rng, *scenes[i % 3], PATCH, BATCH) for i in range(10)]
    return dict(module=module, opt=opt, state=state, step=step, grad=grad, scenes=scenes, batches=batches)


def _port_state(params, stage=1):
    model = MSTPlusPlus(stage=stage)
    model.load_state_dict(from_jax_params(params["params"]))
    cfg = train.make_optimizer(lr=LR, total_steps=TOTAL, warmup=WARMUP)
    return train.TrainState(model, *cfg.build(model.parameters())), cfg


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _params_agree(model, jax_params, bound: float) -> None:
    want = from_jax_params(jax_params["params"])
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    diffs = torch.cat([(got[k].detach() - want[k]).flatten() for k in want])
    assert diffs.abs().max() <= bound, (float(diffs.abs().max()), bound)
    assert diffs.pow(2).mean().sqrt() <= RMS_OF_BOUND * bound


@pytest.mark.parametrize("lr,total,warmup", [(LR, TOTAL, WARMUP), (4e-4, 300, 1), (1e-3, 50, 0), (3e-4, 7, 6)])
def test_schedule_equals_optax_at_every_count(lr, total, warmup):
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total)
    cfg = train.make_optimizer(lr=lr, total_steps=total, warmup=warmup)
    model = torch.nn.Linear(2, 2)
    opt, sched = cfg.build(model.parameters())
    for count in range(total + 6):
        assert abs(cfg.schedule(count) - float(want(count))) <= 1e-7, count
        assert opt.param_groups[0]["lr"] == cfg.schedule(count)  # the rate of update `count`
        opt.step()
        sched.step()


def test_first_update_runs_at_rate_zero(jx):
    """optax evaluates the schedule at the count before the update: after a
    warmup the first step leaves the parameters where they were."""
    state, _ = _port_state(jx["state"].params)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, _ = train.make_train_step()(state, *jx["batches"][0])
    assert all(torch.equal(before[k], v) for k, v in state.model.state_dict().items())


def test_one_step_loss_and_gradients(jx):
    rgb, hsi = jx["batches"][0]
    (value, pred), grads = jx["grad"](jx["state"].params, jx["module"], jnp.asarray(rgb), jnp.asarray(hsi), "mrae")
    state, _ = _port_state(jx["state"].params)
    got, got_pred = train.loss_fn(state.model, torch.from_numpy(rgb), torch.from_numpy(hsi), "mrae")
    got.backward()
    assert _rel(got.item(), float(value)) <= LOSS_REL
    assert np.abs(got_pred.detach().numpy() - np.asarray(pred)).max() < 5e-4
    want = from_jax_params(grads["params"])
    for name, p in state.model.named_parameters():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        assert float((p.grad - want[name]).abs().max()) <= GRAD_REL * scale, name


def test_five_steps_losses_and_parameters(jx):
    jstate, jlosses = jx["state"], []
    state, cfg = _port_state(jstate.params)
    step, losses = train.make_train_step("mrae"), []
    for rgb, hsi in jx["batches"][:5]:
        jstate, m = jx["step"](jstate, jnp.asarray(rgb), jnp.asarray(hsi))
        jlosses.append(float(m["loss"]))
        state, mt = step(state, rgb, hsi)
        losses.append(float(mt["loss"]))
        assert _rel(float(mt["rmse"]), float(m["rmse"])) <= TRAIL_REL
        assert abs(float(mt["psnr"]) - float(m["psnr"])) <= 1e-3
    assert state.step == int(jstate.step) == 5
    for a, b in zip(losses, jlosses):
        assert _rel(a, b) <= TRAIL_REL, (losses, jlosses)
    _params_agree(state.model, jstate.params, 2 * sum(cfg.schedule(c) for c in range(5)))


def test_jax_train_state_carries_across(jx):
    """Params, Adam's mu and nu and the count of a JAX state after two
    steps, carried into the port's model, optimizer and schedule: one more
    step agrees on both sides."""
    jstate = jx["state"]
    for rgb, hsi in jx["batches"][:2]:
        jstate, _ = jx["step"](jstate, jnp.asarray(rgb), jnp.asarray(hsi))
    adam = jstate.opt_state[0]
    count = int(adam.count)
    assert count == int(jstate.opt_state[1].count) == 2
    state, cfg = _port_state(jstate.params)
    mu, nu = from_jax_params(adam.mu["params"]), from_jax_params(adam.nu["params"])
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu[name].clone(),
                                    "exp_avg_sq": nu[name].clone()}
    state.scheduler.last_epoch = count
    state.optimizer.param_groups[0]["lr"] = cfg.schedule(count)
    state.step = count

    rgb, hsi = jx["batches"][2]
    jstate, m = jx["step"](jstate, jnp.asarray(rgb), jnp.asarray(hsi))
    state, mt = train.make_train_step("mrae")(state, rgb, hsi)
    assert _rel(float(mt["loss"]), float(m["loss"])) <= LOSS_REL
    assert state.step == int(jstate.step) == 3
    _params_agree(state.model, jstate.params, 2 * cfg.schedule(count))
    want_nu = from_jax_params(jstate.opt_state[0].nu["params"])
    for name, p in state.model.named_parameters():
        got = state.optimizer.state[p]["exp_avg_sq"]
        assert float((got - want_nu[name]).abs().max()) <= 1e-3 * float(want_nu[name].abs().max()) + 1e-30, name


def test_sample_patches_bit_for_bit(jx):
    rgb, hsi = jx["scenes"][0]
    for seed in range(3):
        a = train.sample_patches(np.random.default_rng(seed), rgb, hsi, 24, 5)
        b = jtrain.sample_patches(np.random.default_rng(seed), rgb, hsi, 24, 5)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_patch_batches_bit_for_bit(jx):
    scenes = [data.Scene(rgb, hsi) for rgb, hsi in jx["scenes"][:2]]
    jscenes = [jdata.Scene(rgb, hsi) for rgb, hsi in jx["scenes"][:2]]
    assert list(data.patch_grid(64, 64, 16, 8)) == list(jdata.patch_grid(64, 64, 16, 8))
    for shuffle in (True, False):
        got = list(data.patch_batches(scenes, crop=16, stride=8, batch=7, seed=3, shuffle=shuffle))
        want = list(jdata.patch_batches(jscenes, crop=16, stride=8, batch=7, seed=3, shuffle=shuffle))
        assert len(got) == len(want) and got[-1][0].shape[0] == want[-1][0].shape[0]
        for (r, h), (jr, jh) in zip(got, want):
            assert np.array_equal(r, jr) and np.array_equal(h, jh)


@pytest.mark.parametrize("shape", [(3, 64, 64, 0), (2, 37, 50, 5)])
def test_synthetic_scenes_match_jax(shape):
    n, h, w, seed = shape
    got = train.synthetic_scenes(n, h, w, seed, device="cpu")
    want = jtrain.synthetic_scenes(n, h, w, seed)
    assert len(got) == len(want) == n
    for (r, c), (jr, jc) in zip(got, want):
        assert r.shape == jr.shape == (h, w, 3) and c.shape == jc.shape == (h, w, 31)
        assert r.dtype == c.dtype == np.float32
        assert np.abs(r - jr).max() <= SCENE_TOL
        assert np.abs(c - jc).max() <= SCENE_TOL


@pytest.mark.parametrize("shape", [(2, 64, 64, 11), (1, 45, 70, 3)])
def test_xgen_scenes_match_jax(shape):
    n, h, w, seed = shape
    got = train.xgen_scenes(n, h, w, seed, device="cpu")
    want = jtrain.xgen_scenes(n, h, w, seed)
    for (r, c), (jr, jc) in zip(got, want):
        assert np.array_equal(r, jr)  # NumPy on both sides
        assert np.abs(c - jc).max() <= SCENE_TOL


def test_bad_arguments_raise(monkeypatch):
    with pytest.raises(ValueError, match="must exceed warmup"):
        train.make_optimizer(total_steps=10, warmup=10)
    with pytest.raises(ValueError, match="loss must be one of"):
        train.make_train_step("l2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: train.synthetic_scenes(1, 8, 8), lambda: train.convergence_demo(steps=4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):  # None means the card
            fn()


def test_convergence_demo_meets_the_jax_bars():
    """The JAX package's bars for its own demo
    (``tests/test_models_eval_export.py:214-225``)."""
    out = train.convergence_demo(steps=40, device="cpu")
    assert out["resumed_step"] == 40
    assert out["loss_last"] < 0.5 * out["loss_first"]
    assert out["psnr_final"] - out["psnr_init"] >= 6.0, out


def test_slice_against_jax_ten_steps(jx):
    """Ten steps on both sides from the same params and patches, then the
    eval harness on a held-out scene: PSNR within 0.1 dB."""
    jstate = jx["state"]
    state, _ = _port_state(jstate.params)
    step = train.make_train_step("mrae")
    for rgb, hsi in jx["batches"]:
        jstate, _ = jx["step"](jstate, jnp.asarray(rgb), jnp.asarray(hsi))
        state, _ = step(state, rgb, hsi)
    held = jx["scenes"][3]

    @jax.jit
    def apply(params, rgb):
        with no_fused_ffn():
            return jx["module"].apply(params, rgb[None])[0]

    want = jeval.validate(lambda rgb: apply(jstate.params, jnp.asarray(rgb)), [held], crop=0)
    got = meval.validate(meval.model_apply_fn(state.model), [held], crop=0)
    assert abs(got["psnr"] - want["psnr"]) <= 0.1, (got, want)
    assert _rel(got["mrae"], want["mrae"]) <= 1e-2


# --- the differentiable forward and the weight cache (models/mst_plus_plus.py) ---


def _seeded(stage=1):
    from animal_vision_tpu_torch.models.zoo import init_weights

    return init_weights(MSTPlusPlus(stage=stage), torch.Generator().manual_seed(4))


def test_forward_under_grad_equals_plain_gradients():
    """On the CPU ``forward(x)`` under grad takes the live plain path: the
    same gradients as ``forward(x, plain=True)``, none of them zero."""
    model = _seeded()
    x = torch.from_numpy(np.random.default_rng(2).random((2, 16, 24, 3), dtype=np.float32))
    grads = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        model(x, plain=plain).square().mean().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
    assert all(float(g.abs().max()) > 0 for g in grads[0].values())


def test_kernel_forward_reads_the_weights_after_a_step():
    """The weight cache follows the parameters' version counters: after an
    optimizer step (and after an in-place edit), ``forward(x)`` under
    ``no_grad`` equals the live plain forward and a fresh model loaded with
    the new weights. A cache keyed by the device alone fails here."""
    model = _seeded()
    x = torch.from_numpy(np.random.default_rng(3).random((1, 16, 16, 3), dtype=np.float32))
    with torch.no_grad():
        before = model(x)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model(x, plain=True).mean().backward()
    opt.step()
    with torch.no_grad():
        after = model(x)
    assert not torch.equal(after, before)
    fresh = MSTPlusPlus(stage=1)
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(after, fresh(x))
    assert torch.equal(after, model(x, plain=True).detach())
    with torch.no_grad():
        model.conv_out.weight.mul_(0.5)
        assert not torch.equal(model(x), after)
        stamp = model._cache.layouts["cpu"][0]
        model(x)
        assert model._cache.layouts["cpu"][0] is stamp  # nothing moved: no rebuild
