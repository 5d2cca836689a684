"""The NN emission surrogate (solve/nn.py, a torch.nn MLP) against
soc_tpu's flax + optax one, on inputs made from a numpy seed.

Tolerances: the forward pass of weights carried across with
convert.mlp_from_flax_params is float32 matrix products in another order
than XLA's: rtol 1e-5 (the linear normalization's raw outputs cross
zero: there also 1e-5 of the largest entry). Adam steps from the same
parameters and batch: the loss, the gradients and the updated parameters
within 1e-6 relative to each tensor's largest entry (the gradients sum
over the batch in another order). A training run is held to soc_tpu's
own held-out bounds (tests/test_nn.py:27-35): median |dex error| < 0.02,
95th percentile < 0.1. A file written by one package carries the model
bit for bit to the other (see test_port_nn_read_by_soc_tpu for the
solves' bounds).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soc_tpu.pipeline import mabu as jmabu
from soc_tpu.solve import nn as jnn

from soc_tpu_torch import convert
from soc_tpu_torch.solve import nn as tnn

torch.set_num_threads(2)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flax_model(n_in, hidden, n_out, seed):
    """soc_tpu's model dict with flax-initialised weights and seeded
    normalizations."""
    model = jnn.EmissionMLP(hidden=tuple(hidden), n_out=n_out)
    params = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                       jnp.zeros((1, n_in))))
    rng = np.random.default_rng(seed)
    return dict(params=params, hidden=tuple(hidden),
                in_mu=rng.normal(0, 2, n_in), in_sd=rng.uniform(0.5, 2, n_in),
                out_mu=rng.normal(-3, 1, n_out),
                out_sd=rng.uniform(0.5, 2, n_out), n_out=n_out)


@pytest.fixture(scope="module")
def trained():
    freq = np.logspace(11.5, 15, 24)
    kabs = 1e-21 * (freq / 1e12) ** 1.7
    rng = np.random.default_rng(2)
    strength = 10.0 ** rng.uniform(1, 5, 3000)
    base = (freq / freq.max()) ** -1
    absorbed = (strength[:, None] * base[None, :]).astype(np.float32)
    emitted, _ = jmabu.solve_equilibrium_eqdust(kabs, freq, absorbed)
    iabs = [4, 10, 16, 22]
    model = tnn.nn_fit(absorbed[:2500, iabs], emitted[:2500], CPU,
                       epochs=400, batch=256, seed=1)
    return model, absorbed, emitted, iabs


@pytest.mark.parametrize("hidden,n_in,n_out,seed", [
    ((13, 17, 13), 4, 24, 0), ((8,), 3, 5, 1), ((32, 16), 6, 10, 2)])
def test_nn_solve_matches_soc_tpu(hidden, n_in, n_out, seed):
    md = _flax_model(n_in, hidden, n_out, seed)
    rng = np.random.default_rng(seed + 10)
    absorbed = (10.0 ** rng.uniform(-2, 3, (300, n_in))).astype(np.float32)
    want = jnn.nn_solve(md, absorbed)
    np.testing.assert_allclose(tnn.nn_solve(md, absorbed, CPU), want,
                               rtol=1e-5)
    lin = dict(md, norm="ref-linear",
               in_scale=rng.uniform(0.5, 2, n_in).astype(np.float32),
               out_scale=rng.uniform(0.5, 2, n_out).astype(np.float32))
    want = jnn.nn_solve(lin, absorbed)
    np.testing.assert_allclose(tnn.nn_solve(lin, absorbed, CPU), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_flax_params_round_trip():
    """mlp_from_flax_params then flax_params_from_mlp returns the weights
    bit for bit, and the module's forward equals flax's apply."""
    md = _flax_model(4, (13, 17, 13), 9, 3)
    mlp = convert.mlp_from_flax_params(md["params"], md["hidden"], 9, CPU)
    back = convert.flax_params_from_mlp(mlp)
    for name, layer in md["params"]["params"].items():
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back["params"][name][k], layer[k])
    x = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    want = np.asarray(jnn.EmissionMLP(hidden=(13, 17, 13), n_out=9).apply(
        md["params"], x))
    with torch.no_grad():
        got = mlp(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_adam_steps_match_optax(seed):
    """Three Adam steps on one batch from the same parameters: each step's
    loss, gradients and updated parameters as optax's."""
    md = _flax_model(4, (13, 17, 13), 6, seed)
    rng = np.random.default_rng(seed + 20)
    xb = rng.normal(size=(256, 4)).astype(np.float32)
    yb = rng.normal(size=(256, 6)).astype(np.float32)
    model = jnn.EmissionMLP(hidden=(13, 17, 13), n_out=6)
    params = jax.tree_util.tree_map(jnp.asarray, md["params"])
    tx = optax.adam(3e-3)
    state = tx.init(params)
    mlp = convert.mlp_from_flax_params(md["params"], (13, 17, 13), 6, CPU)
    opt = tnn.adam(mlp, 3e-3, 3)

    def loss_fn(p):
        return jnp.mean((model.apply(p, xb) - yb) ** 2)

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    for _ in range(3):
        loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads_j, state)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        loss_t = tnn.mse_loss(mlp, torch.as_tensor(xb), torch.as_tensor(yb))
        loss_t.backward()
        close(float(loss_t.detach()), float(loss_j))
        for i, layer in enumerate(mlp.layers):
            g = jax.device_get(grads_j["params"]["Dense_%d" % i])
            close(layer.weight.grad.numpy().T, g["kernel"])
            close(layer.bias.grad.numpy(), g["bias"])
        opt.step()
        new_t = convert.flax_params_from_mlp(mlp)
        for name, layer in jax.device_get(params)["params"].items():
            for k in ("kernel", "bias"):
                close(new_t["params"][name][k], layer[k])


def test_init_is_flax_lecun_normal():
    """The init draws lecun_normal kernels (sd sqrt(1/fan_in), truncated at
    2 sd) and zero biases, the same for the same generator seed."""
    a = tnn.EmissionMLP(200, (300,), 200)
    b = tnn.EmissionMLP(200, (300,), 200)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    fl = jax.device_get(jnn.EmissionMLP(hidden=(300,), n_out=200).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 200))))["params"]
    for i, layer in enumerate(a.layers):
        w = layer.weight.detach().numpy()
        np.testing.assert_array_equal(w, b.layers[i].weight.detach().numpy())
        assert not layer.bias.detach().numpy().any()
        sd = np.sqrt(1.0 / layer.in_features)
        assert np.abs(w).max() <= 2.0 * sd / tnn._TRUNC_SD + 1e-7
        np.testing.assert_allclose(w.std(), fl["Dense_%d" % i]["kernel"]
                                   .std(), rtol=0.02)


def test_nn_fit_accuracy_heldout(trained):
    model, absorbed, emitted, iabs = trained
    pred = tnn.nn_solve(model, absorbed[2500:, iabs], CPU)
    truth = emitted[2500:]
    m = truth > truth.max() * 1e-8
    rel = np.abs(np.log10(pred[m]) - np.log10(truth[m]))
    assert np.median(rel) < 0.02, np.median(rel)
    assert np.percentile(rel, 95) < 0.1


def test_port_nn_read_by_soc_tpu(tmp_path, trained):
    """A port-written .nn read by soc_tpu: the same weights and
    normalizations bit for bit, so soc_tpu solves it as it solves the
    port's model (1e-6); each package's solve of the file within 1e-6 of
    its solve of the model. Across the packages the two float32 forward
    passes differ in their order of additions, which 10**(out_sd y +
    out_mu) amplifies by up to ln(10) out_sd: rtol 1e-4 (3.7e-5
    measured)."""
    model, absorbed, _, iabs = trained
    x = absorbed[:64, iabs]
    tnn.nn_save(tmp_path / "d.nn", model)
    back = jnn.nn_load(tmp_path / "d.nn")
    assert back["hidden"] == (13, 17, 13) and back["n_out"] == 24
    for name, layer in model["params"]["params"].items():
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back["params"]["params"][name][k],
                                          layer[k])
    for k in ("in_mu", "in_sd", "out_mu", "out_sd"):
        np.testing.assert_array_equal(back[k], model[k])
    np.testing.assert_allclose(jnn.nn_solve(back, x),
                               jnn.nn_solve(model, x), rtol=1e-6)
    np.testing.assert_allclose(
        tnn.nn_solve(tnn.nn_load(tmp_path / "d.nn"), x, CPU),
        tnn.nn_solve(model, x, CPU), rtol=1e-6)
    np.testing.assert_allclose(jnn.nn_solve(back, x),
                               tnn.nn_solve(model, x, CPU), rtol=1e-4)


def test_soc_tpu_nn_loads_without_jax(tmp_path):
    """A soc_tpu-written .nn unpickles and solves in a process with jax,
    jaxlib, flax and optax blocked."""
    md = _flax_model(4, (13, 17, 13), 9, 4)
    jnn.nn_save(tmp_path / "j.nn", md)
    x = (10.0 ** np.random.default_rng(1).uniform(-1, 2, (40, 4))) \
        .astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    code = """
import sys
for m in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[m] = None
sys.path.insert(0, %r)
import numpy as np
from soc_tpu_torch.solve import nn
out = nn.nn_solve(nn.nn_load(%r), np.load(%r), "cpu")
np.save(%r, out)
""" % (ROOT, str(tmp_path / "j.nn"), str(tmp_path / "x.npy"),
       str(tmp_path / "y.npy"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"),
                               jnn.nn_solve(md, x), rtol=1e-5)


def _reference_net(n_in, nnnet, n_out, seed):
    """The reference's MyNet (ASOC_aux_NN.py:210-271) in torch."""
    torch.manual_seed(seed)
    layers = []
    widths = [n_in] + list(nnnet)
    for a, b in zip(widths[:-1], widths[1:]):
        layers += [torch.nn.Linear(a, b), torch.nn.LeakyReLU()]
    layers.append(torch.nn.Linear(widths[-1], n_out))
    return torch.nn.Sequential(*layers)


def test_import_reference_torch_nn(tmp_path, monkeypatch):
    """A torch state-dict checkpoint (ASOC_aux_NN.py:159) with its
    A_/E_<dust>.norm companions found beside it predicts as the torch
    forward pass under the reference's linear scaling, as soc_tpu's import
    does (tests/test_nn.py:61-85)."""
    net = _reference_net(4, [13, 17, 13], 9, 0)
    state = {("layers." + k): v for k, v in net.state_dict().items()}
    monkeypatch.chdir(tmp_path)
    torch.save(state, "run_adust.nn")
    rng = np.random.default_rng(5)
    ma = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    me = rng.uniform(0.5, 2.0, 9).astype(np.float32)
    ma.tofile("A_adust.norm")
    me.tofile("E_adust.norm")
    model = tnn.nn_load("run_adust.nn")
    assert model["norm"] == "ref-linear"
    assert model["hidden"] == (13, 17, 13)
    absorbed = rng.uniform(0.1, 10.0, (50, 4)).astype(np.float32)
    got = tnn.nn_solve(model, absorbed, CPU)
    with torch.no_grad():
        want = net(torch.tensor(absorbed / ma[None, :])).numpy() \
            * me[None, :]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(jnn.nn_solve(model, absorbed), got,
                               rtol=2e-5, atol=1e-6)


def test_import_torch_nn_norm_mismatch(tmp_path):
    """Norm files of the wrong length are refused (tests/test_nn.py:88-107);
    a transposed (strided) saved tensor imports as its values."""
    w = torch.arange(12.0).reshape(4, 3).t()
    torch.save({"layers.0.weight": w, "layers.0.bias": torch.zeros(3)},
               tmp_path / "x_d.nn")
    np.ones(7, np.float32).tofile(tmp_path / "A_d.norm")
    np.ones(3, np.float32).tofile(tmp_path / "E_d.norm")
    with pytest.raises(ValueError, match="norm-file lengths"):
        tnn.import_torch_nn(tmp_path / "x_d.nn",
                            a_norm=tmp_path / "A_d.norm",
                            e_norm=tmp_path / "E_d.norm")
    np.ones(4, np.float32).tofile(tmp_path / "A_d.norm")
    model = tnn.nn_load(tmp_path / "x_d.nn")
    np.testing.assert_array_equal(model["params"]["params"]["Dense_0"]
                                  ["kernel"], np.arange(12.0).reshape(4, 3))
