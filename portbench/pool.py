"""What a run makes from its seed, on the device: the weights, the pool
of pairs, and the seeds of its requests and steps.

The weights are a state_dict under the reference checkpoint's names
(`weight_shapes`), drawn in one call of a generator on the device:
every conv weight and bias uniform in (-b, b), b = sqrt(6 / fan_in) for
a hidden conv's weight (He's uniform bound, which keeps the activations'
scale through a LeakyReLU network whose eval BatchNorm is the identity),
OUTPUT_GAIN / sqrt(fan_in) for an output conv's (`outputs`: the mu and
sigma heads, the velocity heads' last conv; small, so that the fields
are smooth and a few voxels large, as a network's early in training:
at He's bound they reach tens of voxels and fold, and a step's loss
then swings with its rounding) and 1 / sqrt(fan_in) for a bias;
BatchNorm scale 1, bias 0, running mean 0, running variance 1.

A pair is a smooth random volume in [0, 1] (two octaves of trilinearly
upsampled noise, min-max normalised), the fixed image, and that volume
warped by a smooth random displacement of up to `DISPLACEMENT` voxels,
the moving image: a stand-in for min-max normalised MRI.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DISPLACEMENT = 3.0  # voxels, the largest component of a pair's displacement
OUTPUT_GAIN = 0.1  # weight bound of the output convs, times 1 / sqrt(fan_in)
_MASK = 2 ** 62


def derive(seed: int, *tags) -> int:
    """A seed for one purpose of a run, from the run's seed."""
    h = int(seed) % _MASK
    for t in tags:
        t = sum(ord(c) * 131 ** i for i, c in enumerate(t)) if isinstance(t, str) else int(t)
        h = (h * 1_000_003 + t + 0x9E3779B9) % _MASK
    return h


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def weight_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """Every entry of the network's state_dict with its shape."""
    nd = len(m["input_size"])
    k3 = (3,) * nd
    k1 = (1,) * nd
    L, K = int(m["total_levels"]), int(m["latent_levels"])
    n0, zdim, lk = int(m["n0"]), nd, L - K
    ch = [n0 * ([1, 2, 4] + [6] * (L - 3))[k] for k in range(L)]
    fb = sum({"samples": zdim, "transformed": 1}.get(i, nd) for i in m["feedback"])
    out: dict[str, tuple[int, ...]] = {}

    def conv(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin, *k)
        out[f"{name}.bias"] = (cout,)

    def unit(name, cin, cout):
        conv(f"{name}._op.0", cin, cout, k3)
        for t in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}._op.1.{t}"] = (cout,)

    def sequence(name, cin, cout, depth):
        for i in range(depth):
            unit(f"{name}._op.{i}", cin if i == 0 else cout, cout)

    cin = [2] + ch[:-1]
    for k in range(L):
        sequence(f"downpath.down_blocks.{k}", cin[k], ch[k], 3)
    for l in range(K):
        c = ch[l + lk]
        enc = f"autoencoder.encoders.{l}"
        if l < K - 1:
            sequence(f"{enc}.sample_merge_block", n0 * zdim + c, c, 2)
        conv(f"{enc}.mu_sigma._conv_mu", c, zdim, k1)
        conv(f"{enc}.mu_sigma._conv_sigma.0", c, zdim, k1)
    d = int(m["cp_depth"])
    for l in range(K):
        name = f"autoencoder.decoders.{l}.velocity_field._op"
        if d == 1:
            conv(f"{name}.0", zdim, nd, k3)
        elif d >= 2:
            unit(f"{name}.0", zdim, n0)
            for i in range(1, d - 1):
                unit(f"{name}.{i}", n0, n0)
            conv(f"{name}.{d - 1}", n0, nd, k1)
    for l in range(K - 1):
        sequence(f"autoencoder.up_blocks.{l + lk}", fb, n0 * zdim, 2)
    return out


def outputs(m: dict) -> set[str]:
    """The convs whose outputs leave the network: the mu and sigma heads and
    each velocity head's last conv."""
    K, d = int(m["latent_levels"]), int(m["cp_depth"])
    out = set()
    for l in range(K):
        out |= {f"autoencoder.encoders.{l}.mu_sigma._conv_mu",
                f"autoencoder.encoders.{l}.mu_sigma._conv_sigma.0"}
        if d >= 1:
            out.add(f"autoencoder.decoders.{l}.velocity_field._op.{d - 1}")
    return out


def make_weights(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The float32 state_dict of the configuration `m`, from `seed`."""
    shapes = weight_shapes(m)
    convs = [n[:-len(".weight")] for n, s in shapes.items()
             if n.endswith(".weight") and len(s) > 1]
    drawn = [f"{c}.{t}" for c in convs for t in ("weight", "bias")]
    sizes = [math.prod(shapes[n]) for n in drawn]
    bounds = []
    for c in convs:
        fan_in = math.prod(shapes[f"{c}.weight"][1:])
        gain = OUTPUT_GAIN if c in outputs(m) else math.sqrt(6.0)
        bounds += [gain / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in)]
    u = torch.rand(sum(sizes), generator=generator(derive(seed, "weights"), device),
                   device=device, dtype=torch.float32)
    scale = torch.repeat_interleave(torch.tensor(bounds, device=device),
                                    torch.tensor(sizes, device=device))
    values = (2.0 * u - 1.0) * scale
    out = dict(zip(drawn, (v.view(shapes[n]) for n, v in zip(drawn, values.split(sizes)))))
    for n, s in shapes.items():
        if n in out:
            continue
        fill = 1.0 if n.endswith(("weight", "running_var")) else 0.0
        out[n] = torch.full(s, fill, device=device, dtype=torch.float32)
    return {n: out[n] for n in shapes}


def _smooth(g, rows, channels, size, coarse, device):
    """Noise on a grid of `coarse` points an axis, trilinearly upsampled."""
    grid = tuple(max(2, -(-s // coarse)) for s in size)
    noise = torch.rand((rows, channels, *grid), generator=g, device=device) * 2 - 1
    mode = "trilinear" if len(size) == 3 else "bilinear"
    return F.interpolate(noise, size=tuple(size), mode=mode, align_corners=True)


def make_pairs(size, count: int, seed: int, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """`count` (moving, fixed) pairs, each (1, *size, 1) float32."""
    g = generator(derive(seed, "pairs"), device)
    nd = len(size)
    vol = _smooth(g, count, 1, size, 16, device) + 0.35 * _smooth(g, count, 1, size, 4, device)
    flat = vol.reshape(count, -1)
    lo, hi = flat.amin(1), flat.amax(1)
    fixed = (vol - lo.view(-1, *[1] * (nd + 1))) / (hi - lo).view(-1, *[1] * (nd + 1))
    disp = _smooth(g, count, nd, size, 20, device) * DISPLACEMENT
    axes = []
    for i, s in enumerate(size):
        shape = [1] * nd
        shape[i] = s
        loc = torch.arange(s, device=device, dtype=torch.float32).view(1, *shape) + disp[:, i]
        axes.append(2.0 * (loc + 0.5) / s - 1.0)
    moving = F.grid_sample(fixed, torch.stack(axes[::-1], -1), mode="bilinear",
                           padding_mode="border", align_corners=False)
    to_cl = lambda t: t.movedim(1, -1).contiguous()
    return [(to_cl(moving[i:i + 1]), to_cl(fixed[i:i + 1])) for i in range(count)]
