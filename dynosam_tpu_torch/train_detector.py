"""Train the YOLOv8-seg detector (tiny scale) on the dense renderer's
analytic instances: the port of scripts/train_detector.py.

Data, loss and optimizer are the reference's:

  * data: `random_scene` (eval/detector_heldout.py, the reference's draws)
    rendered by the port's DenseScenario; the pool keeps uint8 images and
    masks on the host (`build_pool`, `sample_batch`, `targets_from_mask`
    draw from numpy's generator in the reference's order), the gain / bias
    augmentation runs on the device (`train_step`);
  * loss: FCOS-style centre-sampling assignment, per-class BCE, DFL, 1 - IoU
    and the prototype-mask BCE inside each positive's box, per image, then
    the mean over the batch (`build_loss_fn`). The batch is a leading axis,
    where the reference vmaps over images; each image keeps its own
    normalisers;
  * forward: the reference trains with `model.apply(params, x, train=False)`
    and its optimizer acts on the whole variables tree, so BatchNorm uses
    its running statistics and `batch_stats.mean` / `var` are trained like
    any weight (nn/yolov8.py::ConvBnSiLU normalises with them in plain ops,
    which torch differentiates). Autograd through torch ops is the port of
    `jax.value_and_grad`; the loss reaches no Pallas kernel in the
    reference, so the port needs no backward kernel;
  * optimizer: optax's `chain(clip_by_global_norm(5.0), adamw(schedule))`
    with `warmup_cosine_decay_schedule(0, lr, min(100, T // 10), T)`,
    written out as optax orders it (`OptaxAdamW`): clipping by
    g * max / norm only when the norm reaches max; Adam b1 0.9, b2 0.999,
    eps 1e-8 outside the square root, bias correction by the incremented
    count; weight decay 1e-4 on every leaf (biases, BatchNorm scales and
    statistics included) before the learning rate; the schedule evaluated
    in float32 at the count before the update, so the first update has lr 0.

Outputs: the checkpoint (float16, written by nn/weights.py::
write_flax_msgpack in the layout `flax.serialization.to_bytes` writes, so
the reference's `from_bytes` and the port's `load_flax_checkpoint` both
read it) at --out (default results/torch/detector/, never the committed
dynosam_tpu/nn/checkpoints/), its sidecar JSON beside it, and the
optimizer state at --opt-state in the port's own format (`torch.save` of
{"count", "mu", "nu"} keyed by the port's tensor names; the reference
writes flax msgpack there, and the two do not read each other's).
The initial weights come from torch's generator seeded by --seed, where
the reference draws flax's initialisers; the parity tests start both sides
from the same JAX-initialised weights.

Run: python -m dynosam_tpu_torch.train_detector [--steps 1500] [--batch 8]
     [--eval-only] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from dynosam_tpu_torch.eval import detector_heldout
from dynosam_tpu_torch.eval.detector_heldout import MAX_OBJ, NUM_CLASSES, cls_of_oid, random_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "results", "torch", "detector")
CKPT_PATH = os.path.join(OUT_DIR, "yolov8t_seg_synth.msgpack")
COMMITTED_CKPT = os.path.join(ROOT, "dynosam_tpu", "nn", "checkpoints", "yolov8t_seg_synth.msgpack")

# training image geometry: the engine's deploy resolution (both /32-div)
IMG_H, IMG_W = 384, 640
SCALE = "t"
STRIDES = (8, 16, 32)
REG_MAX = 16
MAX_NORM = 5.0
WEIGHT_DECAY = 1e-4


# ---------------------------------------------------------------------------
# data (host numpy, the reference's draw order)
# ---------------------------------------------------------------------------
def build_pool(rng: np.random.Generator, num_scenes: int, cache: str = "", device="cuda"):
    """Pre-rendered training pool: every frame of each scene that shows an
    object, as uint8 images and masks with the scene's class map, until
    3 * num_scenes frames. `cache` (npz path) round-trips the pool across
    chunked runs, in the reference's keys."""
    if cache and os.path.exists(cache):
        z = np.load(cache)
        return list(z["imgs"]), list(z["masks"]), list(z["cmaps"])
    imgs, masks, cmaps = [], [], []
    while len(imgs) < num_scenes * 3:
        scn = random_scene(rng, device=device)
        cm = cls_of_oid(scn)
        for k in range(scn.scn.spec.num_frames):
            fr = scn.frame(k)
            m = fr.mask.cpu().numpy()
            if m.max() <= 0:
                continue
            imgs.append(np.clip(fr.rgb.cpu().numpy() * 255.0, 0, 255).astype(np.uint8))
            masks.append(m.astype(np.uint8))
            cmaps.append(cm)
    if cache:
        os.makedirs(os.path.dirname(os.path.abspath(cache)), exist_ok=True)
        np.savez_compressed(cache, imgs=np.stack(imgs), masks=np.stack(masks), cmaps=np.stack(cmaps))
    return imgs, masks, cmaps


def sample_batch(rng: np.random.Generator, imgs, masks, cmaps, batch: int):
    """A pool batch (uint8), flipped horizontally on the host with
    probability 0.5, and each sample's gain / bias for the device-side
    augmentation."""
    idx = rng.integers(0, len(imgs), size=batch)
    bi, bm, bc = [], [], []
    for i in idx:
        im, m = imgs[i], masks[i]
        if rng.random() < 0.5:
            im, m = im[:, ::-1].copy(), m[:, ::-1].copy()
        bi.append(im)
        bm.append(m)
        bc.append(cmaps[i])
    gain = rng.uniform(0.8, 1.2, size=batch).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, size=batch).astype(np.float32)
    return np.stack(bi), np.stack(bm), np.stack(bc), gain, bias


def burn_sampler(rng: np.random.Generator, pool_size: int, batch: int, steps: int) -> None:
    """Advance the sampler by `steps` batches' draws without building them,
    so a resumed chunk (--start-step) does not replay earlier batches."""
    for _ in range(steps):
        rng.integers(0, pool_size, size=batch)
        rng.random(batch)
        rng.uniform(size=2 * batch)


def targets_from_mask(mask: np.ndarray, cls_map: np.ndarray):
    """Instance mask -> padded ground truth per slot: boxes xyxy, valid,
    class and the instance's binary mask (instances under 12 pixels stay
    invalid)."""
    boxes = np.zeros((MAX_OBJ, 4), np.float32)
    valid = np.zeros((MAX_OBJ,), bool)
    clss = np.zeros((MAX_OBJ,), np.int32)
    inst = np.zeros((MAX_OBJ, mask.shape[0], mask.shape[1]), np.uint8)
    ids = [i for i in np.unique(mask) if i > 0][:MAX_OBJ]
    for s, oid in enumerate(ids):
        on = mask == oid
        if on.sum() < 12:
            continue
        ys, xs = np.nonzero(on)
        boxes[s] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
        valid[s] = True
        clss[s] = cls_map[int(oid)]
        inst[s] = on.astype(np.uint8)
    return boxes, valid, clss, inst


def batch_targets(masks, cmaps):
    """targets_from_mask of each sample, stacked: (boxes, valid, clss, inst)."""
    return tuple(np.stack(t) for t in zip(*(targets_from_mask(m, c) for m, c in zip(masks, cmaps))))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def anchor_grid(h, w, stride, device):
    """Anchor centres (A,) x and y of one level, row-major."""
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * stride
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * stride
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    return cx.reshape(-1), cy.reshape(-1)


LEVEL_RANGE = {8: (0.0, 64.0), 16: (48.0, 128.0), 32: (96.0, 1e9)}


def assign(boxes, valid, cx, cy, stride):
    """FCOS centre sampling: an anchor is positive for a ground truth when
    its centre lies within 2.5 strides of the box centre, inside the box,
    and the box's long side falls in this level's range; the smallest
    such box wins (first index on ties, and 0 for an anchor with none).
    boxes (B, G, 4), valid (B, G) -> pos (B, A), pick (B, A)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    bw, bh = x2 - x1, y2 - y1
    long_side = torch.maximum(bw, bh)
    lo, hi = LEVEL_RANGE[stride]
    on_level = (long_side >= lo) & (long_side < hi) & valid
    bcx, bcy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    r = 2.5 * stride
    cxa, cya = cx[None, :, None], cy[None, :, None]
    near = (torch.abs(cxa - bcx[:, None, :]) < r) & (torch.abs(cya - bcy[:, None, :]) < r)
    inside = ((cxa > x1[:, None, :]) & (cxa < x2[:, None, :])
              & (cya > y1[:, None, :]) & (cya < y2[:, None, :]))
    cand = near & inside & on_level[:, None, :]                    # (B, A, G)
    inf = torch.tensor(float("inf"), device=boxes.device)
    area = torch.where(valid, bw * bh, inf)
    pick = torch.argmin(torch.where(cand, area[:, None, :], inf), dim=-1)
    return torch.any(cand, dim=-1), pick


def dfl_loss(logits, target):
    """Distribution focal loss: cross-entropy against the two integer bins
    bracketing the continuous target, linearly weighted.
    logits (..., REG_MAX), target (...) -> (...)."""
    t = torch.clamp(target, 0.0, REG_MAX - 1 - 1e-3)
    tl = torch.floor(t)
    wr = t - tl
    tl_i = tl.to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, tl_i[..., None])[..., 0]
    lr = torch.gather(logp, -1, torch.clamp(tl_i + 1, max=REG_MAX - 1)[..., None])[..., 0]
    return -((1.0 - wr) * ll + wr * lr)


def decode_dist(logits):
    """(..., 4 * REG_MAX) DFL logits -> (..., 4) expected distances in bins."""
    p = torch.softmax(logits.reshape(logits.shape[:-1] + (4, REG_MAX)), dim=-1)
    return torch.sum(p * torch.arange(REG_MAX, dtype=p.dtype, device=p.device), dim=-1)


def iou_xyxy(a, b):
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    aa = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    ab = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    return inter / torch.clamp(aa + ab - inter, min=1e-9)


def _bce_logits(x, t):
    return torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))


def _take(x, pick):
    """x (B, G, ...) gathered at pick (B, A) -> (B, A, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, pick]


def resize_nearest_4(inst):
    """(B, G, H, W) -> (B, G, H/4, W/4): the pixel jax.image.resize's
    "nearest" takes for an exact 4x reduction, (4i + 2, 4j + 2) (its sample
    centre (i + 0.5) * 4 floored)."""
    return inst[..., 2::4, 2::4]


def image_loss_terms(out, boxes, valid, clss, inst) -> dict:
    """Per-image weighted loss terms of a batch (the reference's
    single_image_loss with the images as a leading axis) -> {"cls", "box",
    "dfl", "mask"}, each (B,)."""
    proto = out["proto"]                                      # (B, Hp, Wp, nm)
    B, hp, wp, nm = proto.shape
    dev = proto.device
    inst_low = resize_nearest_4(inst).reshape(B, MAX_OBJ, hp * wp)
    flatp = proto.reshape(B, hp * wp, nm)
    pxs = torch.arange(wp, dtype=torch.float32, device=dev)
    pys = torch.arange(hp, dtype=torch.float32, device=dev)
    total_cls = total_box = total_dfl = npos_all = mask_loss = mask_cnt = 0.0
    for lvl, stride in enumerate(STRIDES):
        h, w = out["cls"][lvl].shape[1:3]
        cx, cy = anchor_grid(h, w, stride, dev)
        pos, pick = assign(boxes, valid, cx, cy, stride)
        # per-class BCE: positives target the one-hot of their box's class
        cls_logit = out["cls"][lvl].reshape(B, -1, NUM_CLASSES)
        onehot = torch.nn.functional.one_hot(_take(clss, pick).long(), NUM_CLASSES).to(cls_logit.dtype)
        tgt = torch.where(pos[..., None], onehot, 0.0)
        total_cls = total_cls + _bce_logits(cls_logit, tgt).sum(dim=(1, 2))
        # box losses on positives
        bsel = _take(boxes, pick)                             # (B, A, 4)
        ltrb_t = torch.stack([cx - bsel[..., 0], cy - bsel[..., 1], bsel[..., 2] - cx, bsel[..., 3] - cy],
                             dim=-1) / stride
        blog = out["boxes"][lvl].reshape(B, -1, 4 * REG_MAX)
        dfl = dfl_loss(blog.reshape(B, -1, 4, REG_MAX), ltrb_t)
        total_dfl = total_dfl + torch.where(pos[..., None], dfl, 0.0).sum(dim=(1, 2))
        d = decode_dist(blog) * stride
        pred_box = torch.stack([cx - d[..., 0], cy - d[..., 1], cx + d[..., 2], cy + d[..., 3]], dim=-1)
        iou = iou_xyxy(pred_box, bsel)
        total_box = total_box + torch.where(pos, 1.0 - iou, 0.0).sum(dim=1)
        npos = pos.to(torch.float32).sum(dim=1)
        npos_all = npos_all + npos
        # mask loss: each positive's coefficients reconstruct its instance,
        # BCE inside its box at prototype resolution (a plain product, as
        # the reference's `mc @ flatp.T`)
        mc = out["mcoef"][lvl].reshape(B, -1, nm)
        mlogit = torch.matmul(mc, flatp.transpose(1, 2))      # (B, A, Hp * Wp)
        m_t = _take(inst_low, pick)
        bq = bsel / 4.0
        inbox = ((pxs[None, None, None, :] >= bq[..., 0, None, None])
                 & (pxs[None, None, None, :] <= bq[..., 2, None, None])
                 & (pys[None, None, :, None] >= bq[..., 1, None, None])
                 & (pys[None, None, :, None] <= bq[..., 3, None, None])).reshape(B, -1, hp * wp)
        mce = _bce_logits(mlogit, m_t)
        area = torch.clamp(inbox.sum(dim=-1).to(torch.float32), min=1.0)
        per_anchor = torch.where(inbox, mce, 0.0).sum(dim=-1) / area
        mask_loss = mask_loss + torch.where(pos, per_anchor, 0.0).sum(dim=1)
        mask_cnt = mask_cnt + npos
    denom = torch.clamp(npos_all, min=1.0)
    return {"cls": 0.5 * total_cls / denom, "box": 7.5 * total_box / denom, "dfl": 1.5 * total_dfl / denom / 4.0,
            "mask": 2.5 * mask_loss / torch.clamp(mask_cnt, min=1.0)}


def image_losses(out, boxes, valid, clss, inst):
    """Per-image total loss -> (B,), summed in the reference's order."""
    t = image_loss_terms(out, boxes, valid, clss, inst)
    return t["cls"] + t["box"] + t["dfl"] + t["mask"]


def build_loss_fn(model):
    """-> loss_fn(leaves, imgs, boxes, valid, clss, inst): the batch's mean
    loss with the network's tensors taken from `leaves` (a dict of the
    port's state_dict names; the running statistics are trained too, see
    nn/yolov8.py::ConvBnSiLU)."""
    def loss_fn(leaves, imgs, boxes, valid, clss, inst):
        out = torch.func.functional_call(model, leaves, (imgs,))
        return torch.mean(image_losses(out, boxes, valid, clss, inst))

    return loss_fn


# ---------------------------------------------------------------------------
# optimizer (optax's chain, in optax's order)
# ---------------------------------------------------------------------------
def warmup_cosine_lr(count: int, lr: float, total_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, min(100, T // 10), T) at
    update count `count`, in float32: linear warmup from 0, then cosine
    decay to 0 over the remaining steps."""
    f32 = np.float32
    warm = min(100, total_steps // 10)
    if count < warm:
        frac = f32(1.0) - f32(count) / f32(warm)
        return float(f32(0.0 - lr) * frac + f32(lr))
    decay = float(total_steps - warm)
    c = f32(min(float(count - warm), decay))
    cosine = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * c / f32(decay), dtype=f32))
    return float(f32(lr) * cosine)


class OptaxAdamW:
    """clip_by_global_norm(MAX_NORM) then adamw(schedule) over a dict of
    leaves, as optax computes them. `schedule(count)` gives the learning
    rate at the count before the update."""

    def __init__(self, leaves: dict, schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=WEIGHT_DECAY,
                 max_norm=MAX_NORM):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in leaves.items()}

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.mu = {k: v.to(self.mu[k].device) for k, v in sd["mu"].items()}
        self.nu = {k: v.to(self.nu[k].device) for k, v in sd["nu"].items()}

    @torch.no_grad()
    def step(self, leaves: dict, grads: dict) -> dict:
        """One update -> the new leaves (fresh tensors)."""
        names = sorted(leaves)               # jax.tree's order of a dict's leaves
        g_norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in names))
        clip = ~(g_norm < self.max_norm)          # optax: a NaN norm clips too
        count_inc = self.count + 1
        bc1 = 1.0 - np.float32(self.b1) ** np.float32(count_inc)
        bc2 = 1.0 - np.float32(self.b2) ** np.float32(count_inc)
        lr = self.schedule(self.count)
        new = {}
        for k in names:
            g = torch.where(clip, (grads[k] / g_norm) * self.max_norm, grads[k])
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            u = (self.mu[k] / float(bc1)) / (torch.sqrt(self.nu[k] / float(bc2)) + self.eps)
            u = u + self.weight_decay * leaves[k]
            new[k] = leaves[k] + (-lr) * u
        self.count = count_inc
        return new


# ---------------------------------------------------------------------------
# model <-> leaves
# ---------------------------------------------------------------------------
def make_model(device="cuda"):
    from dynosam_tpu_torch.nn import yolov8

    return yolov8.YoloV8Seg(num_classes=NUM_CLASSES, scale=SCALE).eval().to(device)


def leaves_of(state_dict: dict, device="cuda") -> dict:
    """The trained tensors of a state_dict (every one but BatchNorm's batch
    counter), float32 on `device`, requiring a gradient."""
    return {k: v.detach().to(device=device, dtype=torch.float32).clone().requires_grad_(True)
            for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}


def load_leaves(path: str, device="cuda") -> dict:
    """A flax checkpoint read as float32, as the reference's resume reads
    it (from_bytes, then astype(float32)) -> leaves."""
    from dynosam_tpu_torch.nn.weights import read_flax_msgpack, state_dict_from_flax

    return leaves_of(state_dict_from_flax(read_flax_msgpack(path)), device)


def model_with(leaves: dict, device="cuda"):
    """A YoloV8Seg in eval mode holding `leaves`."""
    model = make_model(device)
    sd = {k: v.detach() for k, v in leaves.items()}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    return model


def save_checkpoint(path: str, leaves: dict, meta: dict) -> None:
    """The leaves as a float16 flax checkpoint plus its sidecar JSON."""
    from dynosam_tpu_torch.nn.weights import flax_from_state_dict, write_flax_msgpack

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_flax_msgpack(path, flax_from_state_dict(leaves), dtype=np.float16)
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh, indent=1)


def eval_iou(leaves: dict, num_scenes: int = detector_heldout.NUM_SCENES, seed: int = detector_heldout.SEED,
             device="cuda"):
    """Held-out scenes through the full engine (detector_heldout.evaluate,
    the reference's eval_iou) with the trained float32 weights ->
    (mean IoU, class accuracy, instances, extra fields, the full result)."""
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine

    eng = YoloV8DetectorEngine(model_with(leaves, device), input_hw=(IMG_H, IMG_W), max_detections=8,
                               score_threshold=0.25, class_ids=None, device=device)
    res = detector_heldout.evaluate(num_scenes, seed, device=device, engine=eng)
    extra = {"mean_detected_iou": res["mean_detected_iou"], "missed_rate": res["missed_rate"]}
    return res["mean_mask_iou"], res["class_accuracy"], res["instances"], extra, res


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def make_train_step(model, opt: OptaxAdamW):
    """-> train_step(leaves, imgs_u8, gain, bias, boxes, valid, clss,
    inst_u8) -> (new leaves, loss): uint8 -> float, the gain / bias
    augmentation on the device, the loss's gradient and one update."""
    loss_fn = build_loss_fn(model)

    def train_step(leaves, imgs_u8, gain, bias, boxes, valid, clss, inst_u8):
        imgs = imgs_u8.to(torch.float32) / 255.0
        imgs = torch.clamp(imgs * gain[:, None, None, None] + bias[:, None, None, None], 0.0, 1.0)
        inst = inst_u8.to(torch.float32)
        names = sorted(leaves)
        loss = loss_fn(leaves, imgs, boxes, valid, clss, inst)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        new = opt.step(leaves, grads)
        return {k: v.requires_grad_(True) for k, v in new.items()}, loss.detach()

    return train_step


def to_device(batch, device):
    """Host arrays of one step -> tensors on `device`, in train_step's order."""
    imgs, masks, cmaps, gain, bias = batch
    boxes, valid, clss, inst = batch_targets(masks, cmaps)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (imgs, gain, bias, boxes, valid, clss, inst)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool", type=int, default=60, help="scenes in the pool")
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--start-step", type=int, default=0)
    ap.add_argument("--total-steps", type=int, default=0, help="schedule horizon (default: --steps)")
    ap.add_argument("--no-eval", action="store_true", help="skip held-out eval (intermediate chunks)")
    ap.add_argument("--pool-cache", default=os.path.join(OUT_DIR, "det_pool.npz"))
    ap.add_argument("--opt-state", default=os.path.join(OUT_DIR, "det_opt_state.pt"))
    ap.add_argument("--out", default=CKPT_PATH, help="checkpoint path (its sidecar JSON beside it)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    if args.eval_only:
        # the checkpoint at --out, or the committed one if --out has none
        path = args.out if os.path.exists(args.out) else COMMITTED_CKPT
        miou, cacc, n, extra, _ = eval_iou(load_leaves(path, dev), device=dev)
        fields = {"mean_mask_iou": miou, "class_accuracy": cacc, "instances": n, **extra}
        meta_path = args.out + ".json"
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                meta = json.load(fh)
            meta.update(fields)
            with open(meta_path, "w") as fh:
                json.dump(meta, fh, indent=1)
        print(json.dumps(fields))
        return fields

    total_steps = args.total_steps or args.steps
    model = make_model(dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        leaves = leaves_of(make_model("cpu").state_dict(), dev)
    opt = OptaxAdamW(leaves, lambda c: warmup_cosine_lr(c, args.lr, total_steps))
    if args.start_step > 0:   # chunk resume
        leaves = load_leaves(args.out, dev)
        opt.load_state_dict(torch.load(args.opt_state, map_location=dev, weights_only=True))
    train_step = make_train_step(model, opt)

    rng = np.random.default_rng(args.seed + 1)
    t0 = time.time()
    pool_i, pool_m, pool_c = build_pool(rng, args.pool, cache=args.pool_cache, device=dev)
    print(f"pool: {len(pool_i)} frames ({time.time() - t0:.1f}s)", flush=True)
    burn_sampler(rng, len(pool_i), args.batch, args.start_step)
    for step in range(args.start_step, args.start_step + args.steps):
        batch = sample_batch(rng, pool_i, pool_m, pool_c, args.batch)
        leaves, loss = train_step(leaves, *to_device(batch, dev))
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {float(loss):8.4f} ({time.time() - t0:6.1f}s)", flush=True)

    meta = {"steps": args.start_step + args.steps, "scale": SCALE, "input_hw": [IMG_H, IMG_W],
            "num_classes": NUM_CLASSES}
    if not args.no_eval:
        miou, cacc, n, extra, _ = eval_iou(leaves, device=dev)
        meta.update(mean_mask_iou=miou, class_accuracy=cacc, instances=n, **extra)
    save_checkpoint(args.out, leaves, meta)
    os.makedirs(os.path.dirname(os.path.abspath(args.opt_state)), exist_ok=True)
    torch.save(opt.state_dict(), args.opt_state)
    print(json.dumps(meta))
    return meta


if __name__ == "__main__":
    main()
