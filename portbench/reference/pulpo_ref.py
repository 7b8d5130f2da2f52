"""Plain PyTorch reference of PULPo: the network, the UQ request, the
training step's losses and Adam, and the posterior draws.

Written from the published method (PULPo, arXiv:2407.10567, and its
reference train.py) for the configurations the benchmark runs, and
independent of the measured program: it imports nothing of it, takes
the weights as a state_dict under the reference checkpoint's names, and
computes channels-first in float32 with library operations alone:
`F.conv3d` / `F.conv2d` (TF32 off, `strict_fp32`), `F.grid_sample` for
every warp (border padding, align_corners=False: the reference
SpatialTransformer's mapping), `F.interpolate` for every resize,
`F.avg_pool` (ceil mode) for the pyramid, a ones-kernel conv for NCC's
box sums, autograd for the gradients.

What it covers: `level_res` and `full_res` decodes, any feedback list,
NCC and MSE reconstruction, the diagonal KL, the L2 regulariser, B >= 1,
3D and 2D. Not covered (no cell runs them): Dice, the Jacobian
regulariser, the non-diagonal KL.

`precision` selects the arithmetic (`Precision`): "float32" is the
reference; "bfloat16" and "float8" round each conv's operands and every
stored activation (and, in a backward, the gradients at those points)
to that type: the lower-precision controls that the correctness limits
are set against.

The draws follow the rule the method fixes for reproducible samples: one
generator per (seed, sample index, level) on the device of the inputs,
standard normal float32 of shape (B, *level_size, zdim)
(`sample_seed`, `draw`).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
LEAKY_SLOPE = 0.2
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)
FP8_MAX = 448.0  # largest finite float8_e4m3fn
FP8_E5M2_MAX = 57344.0  # largest finite float8_e5m2


# ----------------------------------------------------------------------
# configuration arithmetic (the method's defaults)
# ----------------------------------------------------------------------

class Arch:
    """Sizes derived from a configuration's `model` dict."""

    def __init__(self, m: dict):
        self.input_size = tuple(int(s) for s in m["input_size"])
        self.ndims = len(self.input_size)
        self.zdim = self.ndims
        self.total_levels = int(m["total_levels"])
        self.latent_levels = int(m["latent_levels"])
        self.lk = self.total_levels - self.latent_levels
        self.n0 = int(m["n0"])
        self.cp_depth = int(m["cp_depth"])
        self.nsteps = int(m["nsteps"])
        self.full_res = m["df_resolution"] == "full_res"
        self.feedback = tuple(m["feedback"])
        mults = [1, 2, 4] + [6] * (self.total_levels - 3)
        self.channels = [self.n0 * mults[k] for k in range(self.total_levels)]
        sizes = [self.input_size]
        for _ in range(self.total_levels - 1):
            sizes.append(tuple(-(-s // 2) for s in sizes[-1]))
        self.global_sizes = sizes

    def level_size(self, l: int) -> tuple[int, ...]:
        return self.global_sizes[l + self.lk]

    def df_size(self, l: int) -> tuple[int, ...]:
        return self.input_size if (l == 0 or self.full_res) else self.level_size(l)

    def feedback_channels(self) -> int:
        per = {"samples": self.zdim, "transformed": 1}
        return sum(per.get(item, self.ndims) for item in self.feedback)

    def window(self, l: int) -> int:
        K = self.latent_levels
        return 9 if K == 1 else 1 + 2 * (K - l)

    def kl_weight(self, l: int) -> float:
        return (2.0 ** self.ndims) ** l

    def recon_weight(self, l: int) -> float:
        if self.full_res:
            w = 1.0
        else:
            w = (2.0 ** self.ndims) ** l if l else 1.0 / (2 ** (self.ndims * self.lk))
        return 4 * w if l == 0 else w

    def reg_weight(self, l: int) -> float:
        if self.full_res:
            return 1.0
        return (2.0 ** self.ndims) ** l if l else 1.0 / (2 ** (self.ndims * self.lk))


# ----------------------------------------------------------------------
# arithmetic of the convs
# ----------------------------------------------------------------------

@contextlib.contextmanager
def strict_fp32():
    """float32 convs and matmuls without TF32, restored afterwards."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _round8(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """t rounded to an 8-bit float type with one scale a tensor (its
    absolute maximum to the type's largest finite value)."""
    scale = largest / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).float() / scale


class _Fp8Operand(torch.autograd.Function):
    """A conv operand in float8_e4m3fn; its gradient passes as computed."""

    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Activation(torch.autograd.Function):
    """An activation stored in float8_e4m3fn, its gradient in float8_e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, FP8_E5M2_MAX)


class _Fp8Output(torch.autograd.Function):
    """A float8 conv's output, rounded to bfloat16; the gradient coming
    back into it in float8_e5m2, as an 8-bit training step takes it."""

    @staticmethod
    def forward(ctx, t):
        return _bf16(t)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, FP8_E5M2_MAX)


class Precision:
    """How a conv is computed: "float32" (the reference), "bfloat16"
    (operands and output rounded to bfloat16, float32 sums; in the
    backward the gradients at those points in bfloat16 too) or "float8"
    (operands in float8_e4m3fn with a scale a tensor, float32 sums, the
    output rounded to bfloat16; in the backward the output's gradient in
    float8_e5m2)."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def conv(self, x, w, b, pad: int):
        fn = F.conv3d if x.dim() == 5 else F.conv2d
        if self.kind == "float32":
            y = fn(x, w, padding=pad)
        elif self.kind == "bfloat16":
            y = _bf16(fn(_bf16(x), _bf16(w), padding=pad))
        else:
            y = _Fp8Output.apply(fn(_Fp8Operand.apply(x), _Fp8Operand.apply(w), padding=pad))
        return y + b.view(1, -1, *[1] * (x.dim() - 2))

    def act(self, t):
        """An activation as the precision stores it: float32, bfloat16, or
        float8_e4m3fn with a scale a tensor (its gradient in float8_e5m2)."""
        if self.kind == "float32":
            return t
        return _bf16(t) if self.kind == "bfloat16" else _Fp8Activation.apply(t)


# ----------------------------------------------------------------------
# operations
# ----------------------------------------------------------------------

def leaky(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


def avg_pool(x):
    fn = F.avg_pool3d if x.dim() == 5 else F.avg_pool2d
    return fn(x, 2, 2, ceil_mode=True)


def resize(x, size):
    """Linear resize (align_corners=False) to `size`."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    mode = "trilinear" if x.dim() == 5 else "bilinear"
    return F.interpolate(x, size=tuple(size), mode=mode, align_corners=False)


def resize_field(x, size):
    """A displacement field resized to `size` and its magnitudes scaled
    by the factor of axis 0."""
    factor = size[0] / x.shape[2]
    if factor == 1:
        return x
    return resize(x, size) * factor


def warp(moving, df):
    """Warp moving (B, C, *S_in) by df (R, nd, *S_out), row r reading
    moving row r % B: trilinear, border padding, the source of output
    voxel g at (g + d) * S_in / (S_out - 1) - 0.5 (grid_sample with
    align_corners=False on coordinates normalised by S_out - 1)."""
    rows, nd = df.shape[0], df.shape[1]
    out_size = df.shape[2:]
    if moving.shape[0] != rows:
        moving = moving.repeat(rows // moving.shape[0], *[1] * (moving.dim() - 1))
    axes = []
    for i, s in enumerate(out_size):
        shape = [1] * nd
        shape[i] = s
        g = torch.arange(s, device=df.device, dtype=torch.float32).view(1, *shape)
        loc = g + df[:, i]
        axes.append(2.0 * (loc / (s - 1) - 0.5))
    grid = torch.stack(axes[::-1], dim=-1)
    return F.grid_sample(moving, grid, mode="bilinear", padding_mode="border",
                         align_corners=False)


def integrate(vec, nsteps: int):
    """Scaling and squaring of a stationary velocity field."""
    vec = vec * (1.0 / 2 ** nsteps)
    for _ in range(nsteps):
        vec = vec + warp(vec, vec)
    return vec


# ----------------------------------------------------------------------
# the draws
# ----------------------------------------------------------------------

def sample_seed(seed: int, sample: int, level: int) -> int:
    """Generator seed of one (sample, level) draw."""
    return ((int(seed) * 1_000_003 + int(sample)) * 1_009 + int(level)) % (2 ** 63)


def draw(seed: int, samples, level: int, batch: int, size, zdim: int, device):
    """Standard normal float32 draws, sample-major rows (S*B, zdim, *size)."""
    out = []
    for s in samples:
        g = torch.Generator(device=device)
        g.manual_seed(sample_seed(seed, s, level))
        e = torch.randn((batch, *size, zdim), generator=g, device=device, dtype=torch.float32)
        out.append(e.movedim(-1, 1))
    return torch.cat(out)


def step_seeds(rng_seed: int, steps: int) -> list[int]:
    """The posterior-draw seed of each of a run's first training steps: a
    CPU generator from `rng_seed`, one draw in [0, 2**62) a step."""
    g = torch.Generator().manual_seed(int(rng_seed))
    return [int(torch.randint(0, 2 ** 62, (1,), generator=g)) for _ in range(steps)]


# ----------------------------------------------------------------------
# the network
# ----------------------------------------------------------------------

class Net:
    """The network on a state_dict `P` (float32 tensors on one device).

    `train`: BatchNorm from the batch (biased variance), recording each
    BatchNorm's running update in `self.stats`; else the running
    statistics."""

    def __init__(self, arch: Arch, P: dict, precision: Precision | None = None,
                 train: bool = False):
        self.a, self.P = arch, P
        self.prec = precision or Precision()
        self.train = train
        self.stats: dict[str, torch.Tensor] = {}

    def conv(self, name, x, pad):
        return self.prec.conv(x, self.P[f"{name}.weight"], self.P[f"{name}.bias"], pad)

    def bn(self, name, x):
        P = self.P
        g, b = P[f"{name}.weight"], P[f"{name}.bias"]
        view = (1, -1) + (1,) * (x.dim() - 2)
        if self.train:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dims)
            var = x.var(dims, unbiased=False)
            m = BN_MOMENTUM
            self.stats[f"{name}.running_mean"] = (
                m * P[f"{name}.running_mean"] + (1 - m) * mean.detach())
            self.stats[f"{name}.running_var"] = (
                m * P[f"{name}.running_var"] + (1 - m) * var.detach())
        else:
            mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        return (x - mean.view(view)) / torch.sqrt(var.view(view) + BN_EPS) * g.view(view) \
            + b.view(view)

    def unit(self, name, x):
        """Conv(k=3, same) -> BatchNorm -> LeakyReLU(0.2)."""
        a = self.prec.act
        return a(leaky(a(self.bn(f"{name}._op.1", a(self.conv(f"{name}._op.0", x, 1))))))

    def sequence(self, name, x, depth):
        for i in range(depth):
            x = self.unit(f"{name}._op.{i}", x)
        return x

    def down(self, x, y):
        h = self.prec.act(torch.cat([x, y], 1))
        acts = []
        for k in range(self.a.total_levels):
            if k:
                h = avg_pool(h)
            h = self.sequence(f"downpath.down_blocks.{k}", h, 3)
            acts.append(h)
        return acts

    def heads(self, name, h):
        a = self.prec.act
        mu = a(self.conv(f"{name}.mu_sigma._conv_mu", h, 0))
        sigma = a(F.softplus(a(self.conv(f"{name}.mu_sigma._conv_sigma.0", h, 0))))
        return mu, sigma

    def velocity(self, l, z):
        name = f"autoencoder.decoders.{l}.velocity_field._op"
        d = self.a.cp_depth
        if d == 0:
            return z
        if d == 1:
            return self.conv(f"{name}.0", z, 0)
        x = z
        for i in range(d - 1):
            x = self.unit(f"{name}.{i}", x)
        return self.prec.act(self.conv(f"{name}.{d - 1}", x, 0))

    def decode(self, x, acts, seed, samples, eps=None):
        """S = len(samples) posterior draws, rows sample-major (S*B).
        Returns per level: mu, sigma, z, individual, combined, final,
        transformed (channels-first)."""
        a = self.a
        B, S = x.shape[0], len(samples)
        tile = lambda t: t.repeat(S, *[1] * (t.dim() - 1))
        if a.full_res:
            level_x = {l: x for l in range(a.latent_levels)}
        else:
            h = x
            for _ in range(a.lk):
                h = avg_pool(h)
            level_x = {0: x}
            for l in range(1, a.latent_levels):
                h = avg_pool(h)
                level_x[l] = h
        out: dict[str, dict[int, torch.Tensor]] = {
            k: {} for k in ("mu", "sigma", "z", "individual", "combined", "final",
                            "transformed")}
        feed = {"samples": "z", "velocity_fields": "individual",
                "individual_dfs": "individual", "combined_dfs": "combined",
                "final_dfs": "final", "transformed": "transformed"}
        for l in reversed(range(a.latent_levels)):
            k = l + a.lk
            enc = f"autoencoder.encoders.{l}"
            if l == a.latent_levels - 1:
                mu, sigma = self.heads(enc, acts[k])
                mu, sigma = tile(mu), tile(sigma)
            else:
                size = a.global_sizes[k]
                fb = self.prec.act(torch.cat([resize(out[feed[item]][l + 1], size)
                                              for item in a.feedback], 1))
                fb = self.sequence(f"autoencoder.up_blocks.{k}", fb, 2)
                h = self.sequence(f"{enc}.sample_merge_block", torch.cat([fb, tile(acts[k])], 1),
                                  2)
                mu, sigma = self.heads(enc, h)
            e = (eps[l] if eps is not None
                 else draw(seed, samples, l, B, a.level_size(l), a.zdim, x.device))
            z = self.prec.act(mu + sigma * e)
            ind = self.velocity(l, z)
            comb = ind if l == a.latent_levels - 1 else (
                ind + resize_field(out["combined"][l + 1], a.level_size(l)))
            fin = resize_field(integrate(comb, a.nsteps), a.df_size(l))
            out["mu"][l], out["sigma"][l], out["z"][l] = mu, sigma, z
            out["individual"][l], out["combined"][l], out["final"][l] = ind, comb, fin
            out["transformed"][l] = warp(level_x[l], fin)
        return out


def cl(t: torch.Tensor) -> torch.Tensor:
    """Channels-first to channels-last."""
    return t.movedim(1, -1)


def cf(t: torch.Tensor) -> torch.Tensor:
    """Channels-last to channels-first."""
    return t.movedim(-1, 1)


# ----------------------------------------------------------------------
# the UQ request
# ----------------------------------------------------------------------

def _std(v: torch.Tensor) -> torch.Tensor:
    """(N, B, C, *S) -> Bessel std over N, averaged over C: (B, *S)."""
    return v.std(0, unbiased=True).mean(1)


@torch.no_grad()
def uq_request(model: dict, P: dict, x, y, N: int, seed: int, first: int,
               precision: str = "float32", block: int = 8) -> dict:
    """Every leaf of an N-sample uncertainty request on the pairs x, y
    (B, *S, 1), channels-last, by level: mean_outputs, avg_dfs, final_dfs,
    outputs (the first `first` samples, (B, first, *S, 1)), output_std,
    individual_df_std, final_df_std, output_mse (level 0),
    output_entropy. The samples are decoded `block` at a time."""
    a = Arch(model)
    with strict_fp32():
        net = Net(a, P, Precision(precision))
        xc, yc = cf(x.float()), cf(y.float())
        acts = net.down(xc, yc)
        B = xc.shape[0]
        per = {"individual": {}, "final": {}, "transformed": {}}
        for s0 in range(0, N, block):
            ids = list(range(s0, min(N, s0 + block)))
            o = net.decode(xc, acts, seed, ids)
            for name in per:
                for l, v in o[name].items():
                    per[name].setdefault(l, []).append(v.reshape(len(ids), B, *v.shape[1:]))
            del o
        stack = {n: {l: torch.cat(vs) for l, vs in d.items()} for n, d in per.items()}
        res: dict[str, dict[int, torch.Tensor]] = {}
        avg = {l: v.mean(0) for l, v in stack["individual"].items()}
        res["avg_dfs"] = {l: cl(v) for l, v in avg.items()}
        combined: dict[int, torch.Tensor] = {}
        final: dict[int, torch.Tensor] = {}
        for l in reversed(range(a.latent_levels)):
            combined[l] = avg[l] if l + 1 not in combined else (
                avg[l] + resize_field(combined[l + 1], tuple(avg[l].shape[2:])))
            final[l] = resize_field(integrate(combined[l], a.nsteps), a.df_size(l))
        res["final_dfs"] = {l: cl(v) for l, v in final.items()}
        res["mean_outputs"] = {l: cl(warp(xc, v)) for l, v in final.items()}
        t = stack["transformed"]
        res["outputs"] = {l: v[:first].movedim(2, -1).transpose(0, 1) for l, v in t.items()}
        res["output_std"] = {l: _std(v) for l, v in t.items()}
        res["output_entropy"] = {
            l: 0.5 * torch.log(2.0 * math.pi * math.e * v.var(0, unbiased=True).mean(1) + 1e-12)
            for l, v in t.items()}
        res["individual_df_std"] = {l: _std(v) for l, v in stack["individual"].items()}
        res["final_df_std"] = {l: _std(v) for l, v in stack["final"].items()}
        res["output_mse"] = {0: ((t[0] - yc[None]) ** 2).mean(0)[:, 0]}
    return res


# ----------------------------------------------------------------------
# the training step
# ----------------------------------------------------------------------

def box_sum(x, win: int):
    """Zero-padded win^nd box sum of a single-channel (B, 1, *S) volume."""
    nd = x.dim() - 2
    fn = F.conv3d if nd == 3 else F.conv2d
    ones = torch.ones((1, 1) + (win,) * nd, device=x.device, dtype=x.dtype)
    return fn(x, ones, padding=win // 2)


def ncc(pred, target, win: int, gamma: float):
    """-gamma * sum over voxels of the batch mean of the local squared
    normalised cross-correlation (a constant window volume)."""
    nd = pred.dim() - 2
    i, j = target, pred
    i_sum, j_sum = box_sum(i, win), box_sum(j, win)
    i2, j2, ij = box_sum(i * i, win), box_sum(j * j, win), box_sum(i * j, win)
    w = float(win ** nd)
    u_i, u_j = i_sum / w, j_sum / w
    cross = ij - u_j * i_sum - u_i * j_sum + u_i * u_j * w
    i_var = i2 - 2 * u_i * i_sum + u_i * u_i * w
    j_var = j2 - 2 * u_j * j_sum + u_j * u_j * w
    cc = cross * cross / (i_var * j_var + 1e-8)
    return -cc.mean(0).sum() * gamma


def mse(pred, target):
    dims = tuple(range(2, pred.dim()))
    return ((pred - target) ** 2).sum(dims).mean()


def kl_standard(mu, sigma, eps: float = 1e-10):
    """KL[N(mu, sigma^2) || N(0, 1)], summed over features, batch mean."""
    b = mu.shape[0]
    s0 = (sigma * sigma).reshape(b, -1)
    m0 = mu.reshape(b, -1)
    per = 0.5 * ((s0 + m0 * m0) / (1.0 + eps) + math.log(1.0 + eps)
                 - torch.log(s0 + eps) - 1.0).sum(1)
    return per.mean()


def l2_reg(df, lamb: float):
    """lamb * prod(S) * mean of the squared forward differences, each on
    the grid cropped to [1:] on the other axes."""
    nd = df.dim() - 2
    size = df.shape[2:]
    base = df[(slice(None), slice(None)) + (slice(1, None),) * nd]
    total = 0.0
    for i in range(nd):
        idx = [slice(None), slice(None)] + [slice(1, None)] * nd
        idx[2 + i] = slice(0, size[i] - 1)
        total = total + (base - df[tuple(idx)]) ** 2
    return total.mean() * lamb * float(math.prod(size))


def losses(a: Arch, model: dict, o: dict, x, y):
    """(total, kl, recon, reg) of one train forward's outputs."""
    kl = recon = reg = 0.0
    recon_terms = tuple(model["recon_loss"])
    for l in range(a.latent_levels):
        kl = kl + a.kl_weight(l) * kl_standard(o["mu"][l], o["sigma"][l])
        pred = o["transformed"][l]
        target = resize(y, pred.shape[2:])
        lvl = 0.0
        w = a.recon_weight(l)
        if "mse" in recon_terms:
            lvl = lvl + w * mse(pred, target)
        if "ncc" in recon_terms:
            lvl = lvl + w * ncc(pred, target, a.window(l), float(model["gamma"]))
        recon = recon + lvl / len(recon_terms)
        reg = reg + a.reg_weight(l) * l2_reg(o["final"][l], float(model["lamb"]))
    kl = kl * float(model["beta"])
    return kl + recon + reg, kl, recon, reg


def train_steps(model: dict, P: dict, batches, seeds, precision: str = "float32"):
    """Train from the state_dict P (not changed) for len(seeds) steps,
    step i on batches[i] ((x, y) channels-last) with posterior seed
    seeds[i]: the method's loss, its gradient by autograd, Adam (b1
    0.9, b2 0.999, eps 1e-8, float32 bias corrections), BatchNorm
    running statistics committed after each step.

    Returns (losses [(total, kl, recon, reg)] a step, the first step's
    gradients, the state_dict after the last step)."""
    a = Arch(model)
    lr = float(model["lr"])
    b1, b2, eps = ADAM["b1"], ADAM["b2"], ADAM["eps"]
    state = {k: v.detach().clone() for k, v in P.items()}
    names = [k for k in state if not k.endswith(("running_mean", "running_var"))]
    mu = {k: torch.zeros_like(state[k]) for k in names}
    nu = {k: torch.zeros_like(state[k]) for k in names}
    out_losses, first_grads = [], None
    with strict_fp32():
        for count, ((x, y), seed) in enumerate(zip(batches, seeds), 1):
            params = {k: state[k].clone().requires_grad_(True) for k in names}
            net = Net(a, {**state, **params}, Precision(precision), train=True)
            xc, yc = cf(x.float()), cf(y.float())
            o = net.decode(xc, net.down(xc, yc), seed, [0])
            total, kl, recon, reg = losses(a, model, o, xc, yc)
            grads = torch.autograd.grad(total, [params[k] for k in names], allow_unused=True)
            grads = {k: torch.zeros_like(state[k]) if g is None else g
                     for k, g in zip(names, grads)}
            out_losses.append(tuple(float(t.detach()) for t in (total, kl, recon, reg)))
            if first_grads is None:
                first_grads = grads
            bc1 = 1 - float(torch.tensor(b1, dtype=torch.float32) ** count)
            bc2 = 1 - float(torch.tensor(b2, dtype=torch.float32) ** count)
            with torch.no_grad():
                for k in names:
                    g = grads[k]
                    mu[k] = (1 - b1) * g + b1 * mu[k]
                    nu[k] = (1 - b2) * g * g + b2 * nu[k]
                    state[k] = state[k] - lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps))
                state.update({k: v.detach() for k, v in net.stats.items()})
            del o, total, params, net
    return out_losses, first_grads, state
