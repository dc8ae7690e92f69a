"""YOLOv8-seg instance-segmentation network (port of dynosam_tpu/nn/yolov8.py).

ultralytics' yolov8-seg architecture: backbone (stem + 4 stages of stride-2
Conv and C2f, then SPPF), FPN top-down and PAN bottom-up neck, per-level
box (DFL logits), class and mask-coefficient branches, and a Proto mask
basis on P3. Submodules carry the reference's flax names, so nn/weights.py
maps a flax checkpoint onto them name for name.

The public forward keeps the reference's layout: NHWC input in 0..1, and a
dict of NHWC head outputs and `proto`. Inside, the network runs NCHW. The
convolutions are cuDNN's, as the reference left them to XLA; TF32 is off
for them (set below and in utils/lie.py), so they compute in full f32.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCALES = {
    # depth, width, max_channels; "t" is the repo's own ~0.9M-parameter
    # variant that the committed checkpoint uses
    "t": (0.34, 0.125, 1024),
    "n": (0.34, 0.25, 1024),
    "s": (0.34, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


def _scale_ch(c: int, width: float, max_ch: int) -> int:
    return _make_divisible(min(c, max_ch) * width)


def _scale_n(n: int, depth: float) -> int:
    return max(1, round(n * depth))


class ConvBnSiLU(nn.Module):
    """Conv2d + BatchNorm (eps 1e-3) + SiLU — ultralytics' `Conv` block.

    BatchNorm always normalises with its running statistics, in plain ops
    in flax's order: the reference runs the model only as
    `model.apply(params, x, train=False)`, serving and training alike, and
    its optimizer acts on the whole variables tree (scripts/train_detector.py:
    350, 462), so `batch_stats.mean` / `var` are themselves trained
    (train_detector.py hands them in through `torch.func.functional_call`),
    a gradient torch's batch_norm refuses. `bn` holds the parameters and
    statistics under BatchNorm2d's names."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)

    def forward(self, x):
        y = self.conv(x)
        bn = self.bn

        def c(v):
            return v[:, None, None]
        # flax's _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias
        y = (y - c(bn.running_mean)) * c(torch.rsqrt(bn.running_var + bn.eps) * bn.weight) + c(bn.bias)
        return F.silu(y)


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBnSiLU(c, c, 3)
        self.cv2 = ConvBnSiLU(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks (ultralytics C2f)."""

    def __init__(self, cin: int, cout: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        self.c = cout // 2
        self.n = n
        self.cv1 = ConvBnSiLU(cin, 2 * self.c, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.c, shortcut))
        self.cv2 = ConvBnSiLU((2 + n) * self.c, cout, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max pools, -inf padded."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        c = cin // 2
        self.cv1 = ConvBnSiLU(cin, c, 1)
        self.cv2 = ConvBnSiLU(4 * c, cout, 1)

    def forward(self, x):
        x = self.cv1(x)
        p1 = F.max_pool2d(x, 5, 1, padding=2)
        p2 = F.max_pool2d(p1, 5, 1, padding=2)
        p3 = F.max_pool2d(p2, 5, 1, padding=2)
        return self.cv2(torch.cat([x, p1, p2, p3], dim=1))


class Proto(nn.Module):
    """Mask prototype head on P3: conv -> 2x transposed conv -> conv -> nm."""

    def __init__(self, cin: int, mid: int, nm: int = 32):
        super().__init__()
        self.cv1 = ConvBnSiLU(cin, mid, 3)
        self.upsample = nn.ConvTranspose2d(mid, mid, 2, stride=2, bias=True)
        self.cv2 = ConvBnSiLU(mid, mid, 3)
        self.cv3 = ConvBnSiLU(mid, nm, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def _upsample2(x):
    # exactly x2: torch's "nearest" picks the source pixel the reference's
    # half-pixel-centre nearest picks
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YoloV8Seg(nn.Module):
    """Full segmentation model (see the module docstring for the layout)."""

    def __init__(self, num_classes: int = 80, scale: str = "n", reg_max: int = 16, nm: int = 32):
        super().__init__()
        depth, width, max_ch = SCALES[scale]

        def ch(c):
            return _scale_ch(c, width, max_ch)

        def nrep(n):
            return _scale_n(n, depth)

        self.num_classes, self.reg_max, self.nm = num_classes, reg_max, nm
        # backbone
        self.b0 = ConvBnSiLU(3, ch(64), 3, 2)
        self.b1 = ConvBnSiLU(ch(64), ch(128), 3, 2)
        self.b2 = C2f(ch(128), ch(128), nrep(3), True)
        self.b3 = ConvBnSiLU(ch(128), ch(256), 3, 2)
        self.b4 = C2f(ch(256), ch(256), nrep(6), True)
        self.b5 = ConvBnSiLU(ch(256), ch(512), 3, 2)
        self.b6 = C2f(ch(512), ch(512), nrep(6), True)
        self.b7 = ConvBnSiLU(ch(512), ch(1024), 3, 2)
        self.b8 = C2f(ch(1024), ch(1024), nrep(3), True)
        self.b9 = SPPF(ch(1024), ch(1024))
        # neck
        self.n12 = C2f(ch(1024) + ch(512), ch(512), nrep(3), False)
        self.n15 = C2f(ch(512) + ch(256), ch(256), nrep(3), False)
        self.n16 = ConvBnSiLU(ch(256), ch(256), 3, 2)
        self.n18 = C2f(ch(256) + ch(512), ch(512), nrep(3), False)
        self.n19 = ConvBnSiLU(ch(512), ch(512), 3, 2)
        self.n21 = C2f(ch(512) + ch(1024), ch(1024), nrep(3), False)
        # heads
        feat_ch = (ch(256), ch(512), ch(1024))
        c_box = max(16, feat_ch[0] // 4, 4 * reg_max)
        c_cls = max(feat_ch[0], min(num_classes, 100))
        c_m = max(feat_ch[0] // 4, nm)
        for i, cin in enumerate(feat_ch):
            for name, c_mid, c_out in (("box", c_box, 4 * reg_max), ("cls", c_cls, num_classes),
                                       ("m", c_m, nm)):
                setattr(self, f"{name}{i}_0", ConvBnSiLU(cin, c_mid, 3))
                setattr(self, f"{name}{i}_1", ConvBnSiLU(c_mid, c_mid, 3))
                setattr(self, f"{name}{i}_2", nn.Conv2d(c_mid, c_out, 1))
        self.proto = Proto(feat_ch[0], _scale_ch(256, width, max_ch), nm)

    def forward(self, x_nhwc) -> Dict[str, List[torch.Tensor]]:
        """(B, H, W, 3) in 0..1 -> {"boxes", "cls", "mcoef": per-level lists of
        (B, Hl, Wl, C), "proto": (B, H/4, W/4, nm)}."""
        x = x_nhwc.permute(0, 3, 1, 2)
        x = self.b1(self.b0(x))
        x = self.b3(self.b2(x))
        p3 = self.b4(x)
        p4 = self.b6(self.b5(p3))
        p5 = self.b9(self.b8(self.b7(p4)))

        n4 = self.n12(torch.cat([_upsample2(p5), p4], dim=1))
        n3 = self.n15(torch.cat([_upsample2(n4), p3], dim=1))
        m4 = self.n18(torch.cat([self.n16(n3), n4], dim=1))
        m5 = self.n21(torch.cat([self.n19(m4), p5], dim=1))

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        out = {"boxes": [], "cls": [], "mcoef": []}
        for i, f in enumerate((n3, m4, m5)):
            for name, key in (("box", "boxes"), ("cls", "cls"), ("m", "mcoef")):
                y = getattr(self, f"{name}{i}_1")(getattr(self, f"{name}{i}_0")(f))
                out[key].append(nhwc(getattr(self, f"{name}{i}_2")(y)))
        out["proto"] = nhwc(self.proto(n3))
        return out


def strides_for(input_hw) -> tuple:
    """The head's strides (P3, P4, P5) at any input size."""
    return (8, 16, 32)


def init_params(seed: int = 0, num_classes: int = 80, scale: str = "n", input_hw=(384, 640),
                dtype=torch.float32, device="cuda"):
    """A freshly initialised network -> (model, its state_dict), torch's
    default initialisation drawn from `seed` (the global generator is left
    as it was). The weights' shapes do not depend on `input_hw`, which is
    kept for the reference's signature."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = YoloV8Seg(num_classes=num_classes, scale=scale)
    model = model.to(device=device, dtype=dtype)
    return model, model.state_dict()
