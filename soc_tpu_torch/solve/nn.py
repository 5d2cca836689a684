"""Neural-network emission surrogate (port of soc_tpu.solve.nn, the
ASOC_aux_NN.py capability) as a torch.nn MLP.

Learns the per-cell mapping log(absorptions at a few reference
wavelengths) -> log(emission spectrum), replacing the per-cell A2E solve
for repeated runs (reference: a PyTorch MLP with LeakyReLU hidden layers,
nnnet=[13,17,13]; ASOC_aux_NN.py:32-210). soc_tpu trains it with flax +
optax; here EmissionMLP is torch.nn with flax's default initialisation
(lecun_normal kernels, zero biases) and Adam is optax.adam's update at
its defaults written in torch, so training behaves the same. The fit and
the solve run on the caller's device; with a CUDA device both run on the
card.

A model dict is soc_tpu's: ``params`` in flax's layout
{"params": {"Dense_i": {"kernel": [in, out], "bias": [out]}}} as NumPy
arrays, with ``hidden``, ``n_out`` and the normalizations. nn_save pickles
it as soc_tpu does, so each package reads the other's ``.nn``;
convert.mlp_from_flax_params / flax_params_from_mlp carry the weights
between the layout and the module.

Reference ``.nn`` files (torch ``state_dict`` checkpoints written by
ASOC_aux_NN.py:159) are read with ``torch.load(weights_only=True)``, with
the reference's linear mean normalization from the ``A_<dust>.norm`` /
``E_<dust>.norm`` companions (ASOC_aux_NN.py:294-296).
"""

import os
import pickle
import re
import zipfile

import numpy as np
import torch
from torch import nn

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# the normal truncated at +-2 sd and rescaled by this factor so that the
# truncated distribution keeps the variance 1 / fan_in
_TRUNC_SD = 0.87962566103423978


class EmissionMLP(nn.Module):
    """Linear layers with LeakyReLU(0.01) between them (soc_tpu's
    EmissionMLP: flax Dense + leaky_relu)."""

    def __init__(self, n_in, hidden, n_out):
        super().__init__()
        widths = [int(n_in)] + [int(h) for h in hidden] + [int(n_out)]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def reset_parameters(self, generator):
        """flax's default init from ``generator``: lecun_normal kernels
        (sd sqrt(1 / fan_in), truncated at 2 sd), zero biases."""
        with torch.no_grad():
            for layer in self.layers:
                sd = (1.0 / layer.in_features) ** 0.5 / _TRUNC_SD
                nn.init.trunc_normal_(layer.weight, std=sd, a=-2.0 * sd,
                                      b=2.0 * sd, generator=generator)
                layer.bias.zero_()

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = nn.functional.leaky_relu(layer(x), 0.01)
        return self.layers[-1](x)


def _log_standardize(x, eps=1e-33):
    lx = np.log10(np.maximum(np.asarray(x, np.float64), eps))
    mu = lx.mean(axis=0)
    sd = lx.std(axis=0) + 1e-8
    return ((lx - mu) / sd).astype(np.float32), mu, sd


def mse_loss(mlp, xb, yb):
    """The training loss: the mean squared error over every entry."""
    return torch.mean((mlp(xb) - yb) ** 2)


class Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) on torch
    tensors, operation for operation: mu = (1 - b1) g + b1 mu, nu =
    (1 - b2) g^2 + b2 nu, each moment divided by its bias correction
    1 - b^t formed in float32 (optax raises the float32 b to the step
    count), then p + (-lr) mu_hat / (sqrt(nu_hat) + eps). torch.optim.Adam
    forms the corrections in float64: at step 1 its update differs from
    optax's by 6.4e-6 relative, 1 - float32(0.999) being 1.29e-5 off.

    Every step's work is on the parameters' device, in place on tensors
    the object owns (the step count and a table of the corrections of
    ``steps`` steps, made on the host at once), so a CUDA graph can
    capture step()."""

    def __init__(self, params, lr, steps, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        dev = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        t = np.arange(steps + 1, dtype=np.float32)
        f32 = np.float32
        self.bc = torch.as_tensor(np.stack(
            [f32(1.0) - f32(b1) ** t, f32(1.0) - f32(b2) ** t], 1),
            device=dev)
        self.count = torch.zeros((), dtype=torch.int64, device=dev)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        g = [p.grad for p in self.params]
        self.count += 1
        bc = torch.index_select(self.bc, 0, self.count.view(1))[0]
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - self.b2))
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(self.nu, bc[1])),
            self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc[0]), den)
        torch._foreach_add_(self.params, torch._foreach_mul(upd, -self.lr))


def adam(mlp, lr, steps):
    """The training's optimizer: optax.adam(lr) at its defaults (Adam),
    for at most ``steps`` steps."""
    return Adam(mlp.parameters(), lr, steps)


def _train_step(mlp, opt, xd, yd, sel):
    """One step on the rows ``sel`` of the samples; returns the loss,
    detached (a loss that keeps its autograd graph alive would keep the
    parameters' gradient accumulators on the stream that made them)."""
    opt.zero_grad()
    loss = mse_loss(mlp, xd[sel], yd[sel])
    loss.backward()
    opt.step()
    return loss.detach()


class _GraphedStep:
    """A training step on full batches captured as one CUDA graph: the
    host issues one replay a step, not the step's ~50 kernels (eager
    steps run at 480-700 a second on an H100's host). The replay runs the
    eager step's kernels on the same tensors, reading the batch's rows
    from ``sel``, a buffer the caller fills first. The warm-up steps a
    capture needs run on a copy of the state, which is then put back."""

    def __init__(self, mlp, opt, xd, yd, batch):
        self.sel = torch.zeros(batch, dtype=torch.int64, device=xd.device)
        with torch.no_grad():
            # detached copies: a clone in autograd would keep the
            # parameters' gradient accumulators alive on this stream,
            # which invalidates the capture
            state = [t.clone() for t in self._state(mlp, opt)]
        side = torch.cuda.Stream(xd.device)
        side.wait_stream(torch.cuda.current_stream(xd.device))
        with torch.cuda.stream(side):
            for _ in range(3):
                _train_step(mlp, opt, xd, yd, self.sel)
        torch.cuda.current_stream(xd.device).wait_stream(side)
        with torch.no_grad():
            for t, saved in zip(self._state(mlp, opt), state):
                t.copy_(saved)
        opt.zero_grad()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.loss = _train_step(mlp, opt, xd, yd, self.sel)

    @staticmethod
    def _state(mlp, opt):
        return list(mlp.parameters()) + opt.mu + opt.nu + [opt.count]

    def __call__(self, sel):
        self.sel.copy_(sel)
        self.graph.replay()
        return self.loss


def nn_fit(absorbed, emitted, device, hidden=(13, 17, 13), epochs=400,
           lr=3e-3, batch=4096, seed=0, verbose=False, stats=None):
    """Train the surrogate on [N, n_abs] -> [N, n_emit] cell samples on
    ``device``: soc_tpu's loop (a np.random.default_rng(seed) permutation
    each epoch, batches of ``batch``, Adam, the MSE loss). The samples stay
    on the device; only each epoch's permutation crosses. On a CUDA device
    the full batches' step is one CUDA graph (_GraphedStep), the same
    kernels as the eager step. ``stats``, a dict if given, receives the
    Adam steps taken.

    Returns a model dict (flax-layout NumPy weights + the input/output
    normalizations) for nn_save / nn_solve.
    """
    from ..convert import flax_params_from_mlp
    device = torch.device(device)
    x, in_mu, in_sd = _log_standardize(absorbed)
    y, out_mu, out_sd = _log_standardize(emitted)
    gen = torch.Generator().manual_seed(int(seed))
    mlp = EmissionMLP(x.shape[1], hidden, y.shape[1])
    mlp.reset_parameters(gen)
    mlp.to(device)
    n = x.shape[0]
    per_epoch = -(-n // batch)
    opt = adam(mlp, lr, epochs * per_epoch)
    rng = np.random.default_rng(seed)
    xd = torch.as_tensor(x, device=device)
    yd = torch.as_tensor(y, device=device)
    graphed = _GraphedStep(mlp, opt, xd, yd, batch) \
        if device.type == "cuda" and n >= batch else None
    loss = None
    for epoch in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        for i0 in range(0, n, batch):
            sel = order[i0:i0 + batch]
            if graphed is not None and len(sel) == batch:
                loss = graphed(sel)
            else:
                loss = _train_step(mlp, opt, xd, yd, sel)
        if verbose and epoch % 50 == 0:
            print(f"  nn_fit epoch {epoch}: loss {float(loss):.5f}")
    if stats is not None:
        stats["steps"] = epochs * per_epoch
    return dict(params=flax_params_from_mlp(mlp), hidden=tuple(hidden),
                in_mu=in_mu, in_sd=in_sd, out_mu=out_mu, out_sd=out_sd,
                n_out=y.shape[1])


def nn_solve(model_dict, absorbed, device, batch=1 << 16):
    """Evaluate the surrogate on ``device``: [CELLS, n_abs] ->
    [CELLS, n_emit] float32 host array. Both normalizations: soc_tpu's
    log-standardized one and the reference's linear one ("ref-linear")."""
    from ..convert import mlp_from_flax_params
    device = torch.device(device)
    mlp = mlp_from_flax_params(model_dict["params"], model_dict["hidden"],
                               model_dict["n_out"], device)
    linear = model_dict.get("norm") == "ref-linear"
    if linear:
        # the reference's normalization: clip, divide by the per-channel
        # means from A_<dust>.norm (ASOC_aux_NN.py:103-110, 309-311)
        a = np.clip(np.asarray(absorbed, np.float32), 1.0e-29, 1.0e32)
        x = a / model_dict["in_scale"][None, :]
    else:
        lx = np.log10(np.maximum(np.asarray(absorbed, np.float64), 1e-33))
        x = ((lx - model_dict["in_mu"]) /
             model_dict["in_sd"]).astype(np.float32)
    outs = []
    with torch.no_grad():
        for i0 in range(0, x.shape[0], batch):
            xb = torch.as_tensor(np.ascontiguousarray(x[i0:i0 + batch]),
                                 device=device)
            outs.append(mlp(xb).cpu().numpy())
    out = np.concatenate(outs) if outs else \
        np.zeros((0, model_dict["n_out"]), np.float32)
    if linear:
        return (out * model_dict["out_scale"][None, :]).astype(np.float32)
    ly = out * model_dict["out_sd"] + model_dict["out_mu"]
    return (10.0 ** ly).astype(np.float32)


def _find_norms(path):
    """(A_<dust>.norm, E_<dust>.norm) beside a checkpoint named
    <prefix>_<dust>.nn, trying every '_'-split of the basename as the dust
    name; (None, None) when there are none."""
    dirname = os.path.dirname(os.path.abspath(path))
    stem = os.path.basename(str(path))
    stem = stem[:-3] if stem.endswith(".nn") else stem
    parts = stem.split("_")
    for i in range(1, len(parts)):
        cand = "_".join(parts[i:])
        ap = os.path.join(dirname, "A_%s.norm" % cand)
        ep = os.path.join(dirname, "E_%s.norm" % cand)
        if os.path.exists(ap) and os.path.exists(ep):
            return ap, ep
    return None, None


def import_torch_nn(path, a_norm=None, e_norm=None):
    """Convert a reference-trained torch ``.nn`` checkpoint to a model dict.

    The reference saves ``model.state_dict()`` of an ``nn.Sequential`` of
    Linear/LeakyReLU pairs as ``<prefix>_<dust>.nn`` and the linear mean
    normalizations as raw-float32 ``A_<dust>.norm`` / ``E_<dust>.norm`` in
    the working directory (ASOC_aux_NN.py:110-113, 159, 294-296). Without
    the norm paths they are looked for next to the checkpoint; without
    norm files the scales are 1 (valid only if the training data were
    already normalized). Norm files of the wrong length raise.
    """
    state = torch.load(path, map_location="cpu", weights_only=True)
    idx = sorted({int(m.group(1)) for k in state
                  for m in [re.match(r"layers\.(\d+)\.(weight|bias)$", k)]
                  if m})
    if not idx:
        raise ValueError("%s: no layers.<i>.weight entries -- not an "
                         "ASOC_aux_NN state dict" % path)
    weights = [(state["layers.%d.weight" % i].numpy(),
                state["layers.%d.bias" % i].numpy()) for i in idx]
    params = {"params": {}}
    for d, (w, b) in enumerate(weights):
        # torch Linear stores [out, in]; flax Dense kernels are [in, out]
        params["params"]["Dense_%d" % d] = {
            "kernel": np.ascontiguousarray(w.T), "bias": np.array(b)}
    hidden = tuple(int(w.shape[0]) for w, _ in weights[:-1])
    n_in = int(weights[0][0].shape[1])
    n_out = int(weights[-1][0].shape[0])

    if a_norm is None or e_norm is None:
        ap, ep = _find_norms(path)
        if ap is not None:
            a_norm, e_norm = a_norm or ap, e_norm or ep
    if a_norm and os.path.exists(a_norm):
        in_scale = np.fromfile(a_norm, np.float32)
    else:
        in_scale = np.ones(n_in, np.float32)
    if e_norm and os.path.exists(e_norm):
        out_scale = np.fromfile(e_norm, np.float32)
    else:
        out_scale = np.ones(n_out, np.float32)
    if len(in_scale) != n_in or len(out_scale) != n_out:
        raise ValueError(
            "%s: norm-file lengths (%d, %d) do not match the network "
            "(%d in, %d out)" % (path, len(in_scale), len(out_scale),
                                 n_in, n_out))
    return dict(params=params, hidden=hidden, n_out=n_out,
                norm="ref-linear", in_scale=in_scale, out_scale=out_scale)


def nn_save(path, model_dict):
    """Pickle the model dict in soc_tpu's format (flax-layout NumPy
    weights); "_"-prefixed keys are left out."""
    with open(path, "wb") as fp:
        pickle.dump({k: v for k, v in model_dict.items()
                     if not k.startswith("_")}, fp)


def nn_load(path):
    """A model dict from a ``.nn`` file: soc_tpu's pickle (or this
    package's, the same format), or a reference torch checkpoint (a zip)."""
    if zipfile.is_zipfile(path):
        return import_torch_nn(path)
    with open(path, "rb") as fp:
        return pickle.load(fp)
