"""Parity of the port's detector training (dynosam_tpu_torch/train_detector.py)
with scripts/train_detector.py, on the CPU at 64x96 images, batch 2, the
repo's tiny scale, from JAX-initialised weights (model.init(PRNGKey(0)))
carried across by state_dict_from_flax: targets, the nearest-resized
instances, the assignment and the loss helpers, each loss term group, the
total loss and the gradient of every leaf (batch_stats included), three
optimizer steps against optax, the checkpoint writer against flax, the
training forward against the serving forward, and the sampler's
burn-forward. The reference's module globals IMG_H / IMG_W are set with
monkeypatch."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dynosam_tpu.nn import yolov8 as jyolo
from dynosam_tpu_torch import train_detector as td
from dynosam_tpu_torch.nn import weights as tweights

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 64, 96, 2
STEPS, TOTAL, LR = 3, 20, 5e-2      # warmup min(100, 20 // 10) = 2: lr 0, lr / 2, then the cosine


def _load_reference():
    spec = importlib.util.spec_from_file_location("ref_train_detector",
                                                  os.path.join(ROOT, "scripts", "train_detector.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()


def _closure(fn):
    """The free variables of a nested function (the reference's loss helpers)."""
    return {n: c.cell_contents for n, c in zip(fn.__code__.co_freevars, fn.__closure__)}


def _batches(n):
    """n batches from a seeded numpy generator: uint8 images, instance masks
    with three objects each (sizes that put positives on P3 and P4), class
    maps, gains and biases."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        masks = np.zeros((B, H, W), np.uint8)
        for b in range(B):
            for oid in (1, 2, 3):
                y0, x0 = rng.integers(0, H - 40), rng.integers(0, W - 60)
                masks[b, y0:y0 + rng.integers(10, 40), x0:x0 + rng.integers(12, 60)] = oid
        out.append((rng.integers(0, 256, size=(B, H, W, 3)).astype(np.uint8), masks,
                    rng.integers(0, 2, size=(B, 6)).astype(np.int32),
                    rng.uniform(0.8, 1.2, size=B).astype(np.float32), rng.uniform(-0.1, 0.1, size=B).astype(np.float32)))
    return out


def _aug(imgs_u8, gain, bias):
    """train_step's uint8 -> float and gain / bias augmentation, in numpy f32."""
    x = imgs_u8.astype(np.float32) / np.float32(255.0)
    return np.clip(x * gain[:, None, None, None] + bias[:, None, None, None], 0.0, 1.0)


@pytest.fixture(scope="module")
def reference_run():
    """JAX: the variables, then per step the loss, the gradients and the
    global norm, and the variables after STEPS optax updates, one jitted
    function for all steps."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "IMG_H", H)
    mp.setattr(ref, "IMG_W", W)
    try:
        model = jyolo.YoloV8Seg(num_classes=ref.NUM_CLASSES, scale=ref.SCALE)
        var = model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.float32))
        loss_fn = ref.build_loss_fn(model)
        sched = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=min(100, TOTAL // 10), decay_steps=TOTAL)
        tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(sched))

        @jax.jit
        def step(params, opt_state, imgs, boxes, valid, clss, inst):
            loss, grads = jax.value_and_grad(loss_fn)(params, imgs, boxes, valid, clss, inst)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss, grads, optax.global_norm(grads)

        params, opt_state, steps = var, tx.init(var), []
        for imgs_u8, masks, cmaps, gain, bias in _batches(STEPS):
            boxes, valid, clss, inst = (np.stack(t) for t in zip(*(ref.targets_from_mask(m, c)
                                                                   for m, c in zip(masks, cmaps))))
            params, opt_state, loss, grads, norm = step(
                params, opt_state, jnp.asarray(_aug(imgs_u8, gain, bias)), jnp.asarray(boxes), jnp.asarray(valid),
                jnp.asarray(clss), jnp.asarray(inst.astype(np.float32)))
            steps.append((float(loss), jax.tree.map(np.asarray, grads), float(norm)))
        yield {"var": jax.tree.map(np.asarray, var), "steps": steps, "final": jax.tree.map(np.asarray, params),
               "model": model, "sched": sched}
    finally:
        mp.undo()


def _port_leaves(var):
    return td.leaves_of(tweights.state_dict_from_flax(var), "cpu")


def _port_batch(batch):
    imgs_u8, masks, cmaps, gain, bias = batch
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (imgs_u8, gain, bias, *td.batch_targets(masks, cmaps))]


def test_targets_and_nearest_resize():
    for imgs_u8, masks, cmaps, *_ in _batches(2):
        for m, c in zip(masks, cmaps):
            for a, b in zip(ref.targets_from_mask(m, c), td.targets_from_mask(m, c)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            inst = ref.targets_from_mask(m, c)[3].astype(np.float32)
            want = np.asarray(jax.jit(lambda x: jax.image.resize(x, (ref.MAX_OBJ, H // 4, W // 4), "nearest"))(inst))
            np.testing.assert_array_equal(td.resize_nearest_4(torch.from_numpy(inst)).numpy(), want)


def test_assign_and_loss_helpers():
    helpers = _closure(_closure(ref.build_loss_fn(None))["single_image_loss"])
    rng = np.random.default_rng(1)
    (imgs_u8, masks, cmaps, *_), = _batches(1)
    boxes, valid, *_ = td.batch_targets(masks, cmaps)
    for stride in ref.STRIDES:
        h, w = H // stride, W // stride
        jcx, jcy = helpers["anchor_grid"](h, w, stride, jnp.float32)
        cx, cy = td.anchor_grid(h, w, stride, "cpu")
        np.testing.assert_array_equal(cx.numpy(), np.asarray(jcx))
        np.testing.assert_array_equal(cy.numpy(), np.asarray(jcy))
        pos, pick = td.assign(torch.from_numpy(boxes), torch.from_numpy(valid), cx, cy, stride)
        for b in range(B):
            jpos, jpick = helpers["assign"](jnp.asarray(boxes[b]), jnp.asarray(valid[b]), jcx, jcy, stride)
            np.testing.assert_array_equal(pos[b].numpy(), np.asarray(jpos))
            np.testing.assert_array_equal(pick[b].numpy(), np.asarray(jpick))      # first index, all-inf rows 0
    logits = rng.normal(size=(50, 4, ref.REG_MAX)).astype(np.float32)
    target = rng.uniform(-1.0, 17.0, size=(50, 4)).astype(np.float32)           # both clip ends
    np.testing.assert_allclose(td.dfl_loss(torch.from_numpy(logits), torch.from_numpy(target)).numpy(),
                               np.asarray(helpers["dfl_loss"](logits, target)), rtol=1e-6, atol=1e-6)
    flat = logits.reshape(50, -1)
    np.testing.assert_allclose(td.decode_dist(torch.from_numpy(flat)).numpy(),
                               np.asarray(helpers["decode_dist"](flat)), rtol=1e-6, atol=1e-6)
    a = rng.uniform(0, 60, size=(50, 4)).astype(np.float32)
    bb = rng.uniform(0, 60, size=(50, 4)).astype(np.float32)
    np.testing.assert_allclose(td.iou_xyxy(torch.from_numpy(a), torch.from_numpy(bb)).numpy(),
                               np.asarray(helpers["iou_xyxy"](a, bb)), rtol=1e-6, atol=1e-7)


def test_loss_terms_and_every_gradient(reference_run, monkeypatch):
    """The total loss within 1e-5 relative; each term group (class BCE,
    box + DFL, mask BCE, which read disjoint outputs) as its change when
    its outputs are zeroed, within 1e-5 relative plus 1e-6 of the total
    (the JAX side is a difference of two f32 totals); every gradient leaf,
    batch_stats included, within 1e-5 of the leaf's largest."""
    monkeypatch.setattr(ref, "IMG_H", H)
    monkeypatch.setattr(ref, "IMG_W", W)
    var = reference_run["var"]
    loss0, grads0, _ = reference_run["steps"][0]
    batch = _batches(1)[0]
    imgs_u8, gain, bias, boxes, valid, clss, inst = _port_batch(batch)
    imgs = torch.clamp(imgs_u8.float() / 255.0 * gain[:, None, None, None] + bias[:, None, None, None], 0, 1)
    leaves = _port_leaves(var)
    model = td.make_model("cpu")
    loss = td.build_loss_fn(model)(leaves, imgs, boxes, valid, clss, inst.float())
    assert abs(float(loss.detach()) - loss0) <= 1e-5 * abs(loss0)
    names = sorted(leaves)
    grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
    want = tweights.state_dict_from_flax(grads0)
    assert sorted(want) == names and any(k.endswith("running_var") for k in names)
    for k in names:
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5 * scale + 1e-9, err_msg=k)
    # term groups: zero one group's outputs on both sides
    jmodel = reference_run["model"]
    single = _closure(ref.build_loss_fn(jmodel))["single_image_loss"]
    with torch.no_grad():
        out = torch.func.functional_call(model, {k: v.detach() for k, v in leaves.items()}, (imgs,))
    jout = jax.tree.map(lambda a: jnp.asarray(a.numpy()), out)
    jb = [jnp.asarray(a.numpy()) for a in (boxes, valid, clss, inst.float())]
    groups = {"cls": ("cls",), "box": ("boxes",), "mask": ("mcoef", "proto")}
    base = td.image_loss_terms(out, boxes, valid, clss, inst.float())
    for name, keys in groups.items():
        zeroed = {k: ([torch.zeros_like(v) for v in out[k]] if isinstance(out[k], list) else torch.zeros_like(out[k]))
                  if k in keys else out[k] for k in out}
        terms0 = td.image_loss_terms(zeroed, boxes, valid, clss, inst.float())
        port_delta = sum(base[t] - terms0[t] for t in (("box", "dfl") if name == "box" else (name,)))
        jz = jax.tree.map(lambda a: jnp.asarray(a.numpy()), zeroed)
        for b in range(B):
            pick = lambda tree: jax.tree.map(lambda a: a[b], tree)       # noqa: E731
            total = float(single(pick(jout), *[a[b] for a in jb]))
            jd = total - float(single(pick(jz), *[a[b] for a in jb]))
            # the difference of two f32 totals: good to a few ulps of the total
            assert abs(float(port_delta[b]) - jd) <= 1e-5 * abs(jd) + 1e-6 * abs(total), (name, b, float(port_delta[b]), jd)


def test_three_optimizer_steps(reference_run):
    """STEPS updates (lr 0 on the first, the gradient clipped on at least
    one) from the same weights on the same batches: each step's loss within
    1e-5 relative; after the last step all but 0.1% of the elements within
    1e-6 + 1e-4 * lr of JAX's, and every element within 1e-6 + 2e-3 * lr
    (Adam's normalised step m / sqrt(v) carries the full relative error of
    a gradient element that sits near zero)."""
    sched = reference_run["sched"]
    assert float(sched(0)) == 0.0 == td.warmup_cosine_lr(0, LR, TOTAL)
    norms = [s[2] for s in reference_run["steps"]]
    assert max(norms) >= td.MAX_NORM > 0, norms
    leaves = _port_leaves(reference_run["var"])
    opt = td.OptaxAdamW(leaves, lambda c: td.warmup_cosine_lr(c, LR, TOTAL))
    step = td.make_train_step(td.make_model("cpu"), opt)
    for batch, (loss_ref, _, _) in zip(_batches(STEPS), reference_run["steps"]):
        leaves, loss = step(leaves, *_port_batch(batch))
        assert abs(float(loss) - loss_ref) <= 1e-5 * abs(loss_ref)
    want = tweights.state_dict_from_flax(reference_run["final"])
    start = tweights.state_dict_from_flax(reference_run["var"])
    moved = loose = 0
    for k, v in leaves.items():
        err = np.abs(v.detach().numpy() - want[k].numpy())
        assert err.max() <= 1e-6 + 2e-3 * LR, (k, float(err.max()))
        loose += int((err > 1e-6 + 1e-4 * LR).sum())
        moved += int((want[k] != start[k]).sum())
    n = sum(v.numel() for v in leaves.values())
    assert loose <= 1e-3 * n, loose
    assert moved > 0.9 * n


@pytest.mark.parametrize("total", [6, 20, 1500])
def test_schedule_equals_optax(total):
    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-3, warmup_steps=min(100, total // 10), decay_steps=total)
    for c in sorted({0, 1, 2, 5, total // 10, total // 2, total - 1, total, total + 3}):
        assert td.warmup_cosine_lr(c, 2e-3, total) == pytest.approx(float(sched(c)), rel=1e-6, abs=1e-12), c


def test_checkpoint_writer_equals_flax(reference_run, tmp_path):
    """The port's f16 checkpoint: its bytes equal flax's to_bytes of the
    reference's f16 tree (jax.tree.map rebuilds dicts in sorted key order,
    which the writer follows); msgpack_restore and from_bytes read it back
    to the f16 values; load_flax_checkpoint builds the same network."""
    var = reference_run["var"]
    half = jax.tree.map(lambda a: np.asarray(a, np.float16), var)
    path = str(tmp_path / "ck.msgpack")
    tweights.write_flax_msgpack(path, tweights.flax_from_state_dict(_port_leaves(var)), dtype=np.float16)
    raw = open(path, "rb").read()
    assert raw == serialization.to_bytes(half)
    restored = serialization.msgpack_restore(raw)
    got = serialization.from_bytes(var, raw)
    for (pa, a), (pb, b), (_, c) in zip(jax.tree_util.tree_leaves_with_path(half),
                                        jax.tree_util.tree_leaves_with_path(restored),
                                        jax.tree_util.tree_leaves_with_path(got)):
        assert pa == pb and a.dtype == b.dtype == np.float16
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    with open(path + ".json", "w") as fh:
        fh.write('{"num_classes": 2, "scale": "t"}')
    model, _ = tweights.load_flax_checkpoint(path)
    sd = tweights.state_dict_from_flax(half)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


def test_flax_from_state_dict_inverts_the_reader(reference_run):
    var = reference_run["var"]
    back = tweights.flax_from_state_dict(tweights.state_dict_from_flax(var))
    flat_a = jax.tree_util.tree_leaves_with_path(var)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


def test_training_forward_matches_serving_forward(reference_run):
    """The training forward (the leaves, running statistics included, handed
    in through functional_call with a gradient) gives the serving forward
    (the module's own loaded weights under no_grad) within 1e-5 on the same
    weights, and the JAX apply within 1e-4."""
    var = reference_run["var"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, size=(2, H, W, 3)).astype(np.float32))
    leaves = _port_leaves(var)
    model = td.model_with(leaves, "cpu")
    with torch.no_grad():
        serving = model(x)
    train = torch.func.functional_call(model, leaves, (x,))
    jout = reference_run["model"].apply(var, jnp.asarray(x.numpy()), train=False)
    for key in ("boxes", "cls", "mcoef", "proto"):
        s, t_ = serving[key], train[key]
        for a, b, j in (zip(s, t_, jout[key]) if isinstance(s, list) else [(s, t_, jout[key])]):
            np.testing.assert_allclose(b.detach().numpy(), a.numpy(), rtol=0, atol=1e-5)
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(j), rtol=0, atol=1e-4)
    # the stats are leaves of the graph: their gradient exists
    g = torch.autograd.grad(train["proto"].sum(), [leaves["b0.bn.running_var"]])[0]
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_sampler_burn_forward_equals_the_references():
    """--start-step's burn-forward leaves the generator where sampling that
    many batches leaves it, as the reference's does."""
    pool = [np.full((4, 6, 3), i, np.uint8) for i in range(7)]
    masks = [np.full((4, 6), i, np.uint8) for i in range(7)]
    cmaps = [np.zeros(6, np.int32)] * 7
    a, b, c = (np.random.default_rng(5) for _ in range(3))
    for _ in range(4):
        td.sample_batch(a, pool, masks, cmaps, 3)
    td.burn_sampler(b, len(pool), 3, 4)
    for _ in range(4):
        ref.sample_batch(c, pool, masks, cmaps, 3)
    outs = [td.sample_batch(g, pool, masks, cmaps, 3) for g in (a, b)] + [ref.sample_batch(c, pool, masks, cmaps, 3)]
    for x, y, z in zip(*outs):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)


def test_defaults_write_outside_the_reference():
    ck = os.path.realpath(os.path.join(ROOT, "dynosam_tpu"))
    for p in (td.CKPT_PATH, td.OUT_DIR):
        assert not os.path.realpath(p).startswith(ck)
        assert os.path.realpath(p).startswith(os.path.join(os.path.realpath(ROOT), "results"))
    src = open(os.path.join(ROOT, "dynosam_tpu_torch", "train_detector.py")).read()
    assert "/tmp" not in src
