"""Multilayer-perceptron genomic prediction (device-native realization of the
reference's intended-but-disabled DL extension, src/dl.jl:82-211).

The reference's Lux.jl MLP (fully commented out) specified: configurable
hidden layers + dropout, Adam optimizer, MSE loss, GPU device selection.
Here that design is a pure-functional JAX program: parameters are a pytree of
(W, b) pairs, the whole training run is ONE `lax.scan` over epochs compiled
by XLA (full-batch gradients are (n x p) @ (p x h) GEMMs), and
optimizer state is optax Adam. Dropout uses per-epoch fold_in keys so the
compiled loop stays deterministic for a given seed.

The returned Fit carries the standardization moments + weights in
`fit.extras` (plain numpy, checkpoint-friendly) and the locus names in
`b_hat_labels`, so `predict` can re-materialize the network on any genomes
struct with matching loci — the same column-resolution contract as the
linear models (reference src/prediction.jl:215-228).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core.structs import Fit, Genomes, Phenomes
from ..ops.metrics import metrics
from ..prediction import extractxyetc

__all__ = ["mlp", "mlp_apply"]


def _init_params(key, sizes: Sequence[int]) -> List[Tuple[jnp.ndarray, jnp.ndarray]]:
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        key, sub = jax.random.split(key)
        scale = jnp.sqrt(2.0 / din)  # He init for relu stacks
        W = scale * jax.random.normal(sub, (din, dout), dtype=jnp.float32)
        params.append((W, jnp.zeros((dout,), dtype=jnp.float32)))
    return params


def _forward(params, X, dropout_rate: float, key, train: bool):
    h = X
    n_layers = len(params)
    for i, (W, b) in enumerate(params):
        h = jnp.dot(h, W, preferred_element_type=jnp.float32) + b
        if i < n_layers - 1:
            h = jax.nn.relu(h)
            if train and dropout_rate > 0.0:
                key, sub = jax.random.split(key)
                keep = jax.random.bernoulli(sub, 1.0 - dropout_rate, h.shape)
                h = jnp.where(keep, h / (1.0 - dropout_rate), 0.0)
    return h[:, 0]


def mlp_apply(params, X, dropout_rate: float = 0.0):
    """Inference pass (no dropout)."""
    return _forward(params, X, 0.0, jax.random.PRNGKey(0), train=False)


@partial(jax.jit, static_argnames=("n_epochs", "dropout_rate", "learning_rate", "weight_decay"))
def _train(params, Xs, ys, seed, n_epochs: int, dropout_rate: float, learning_rate: float, weight_decay: float):
    opt = optax.adamw(learning_rate, weight_decay=weight_decay)
    opt_state = opt.init(params)
    base_key = jax.random.PRNGKey(seed)

    def loss_fn(p, key):
        pred = _forward(p, Xs, dropout_rate, key, train=True)
        return jnp.mean((pred - ys) ** 2)

    def step(carry, epoch):
        p, s = carry
        key = jax.random.fold_in(base_key, epoch)
        loss, grads = jax.value_and_grad(loss_fn)(p, key)
        updates, s = opt.update(grads, s, p)
        p = optax.apply_updates(p, updates)
        return (p, s), loss

    (params, _), losses = jax.lax.scan(step, (params, opt_state), jnp.arange(n_epochs))
    return params, losses


def mlp(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    idx_trait: int = 0,
    n_hidden_layers: int = 3,
    hidden_dims: Optional[Sequence[int]] = None,
    dropout_rate: float = 0.25,
    n_epochs: int = 1_000,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-4,
    seed: int = 42,
    verbose: bool = False,
) -> Fit:
    """Fit an MLP on standardized allele frequencies with MSE loss + Adam.

    Defaults diverge deliberately from the reference's commented spec
    (Adam 1e-4) — full-batch training on accelerator converges comfortably at
    1e-3 within 1000 epochs on doctest-scale panels.
    """
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    n, p = X.shape
    x_mean = X.mean(axis=0)
    x_std = X.std(axis=0)
    x_std[x_std < 1e-12] = 1.0
    y_mean = float(y.mean())
    y_std = float(y.std())
    y_std = y_std if y_std > 1e-12 else 1.0

    if hidden_dims is None:
        width = int(min(256, max(64, 2 * n)))
        hidden_dims = [max(16, width // (2**i)) for i in range(int(n_hidden_layers))]
    sizes = [p, *[int(h) for h in hidden_dims], 1]

    Xs = jnp.asarray((X - x_mean) / x_std, jnp.float32)
    ys = jnp.asarray((y - y_mean) / y_std, jnp.float32)
    params = _init_params(jax.random.PRNGKey(seed), sizes)
    params, losses = _train(
        params, Xs, ys, seed, int(n_epochs), float(dropout_rate), float(learning_rate),
        float(weight_decay),
    )
    if verbose:
        print(f"mlp: final training MSE {float(losses[-1]):.6f}")

    y_pred = np.asarray(mlp_apply(params, Xs), dtype=np.float64) * y_std + y_mean

    fit = Fit(
        model="mlp",
        b_hat=np.zeros(p + 1),
        b_hat_labels=np.concatenate([np.asarray(["intercept"], dtype=object), loci_alleles]),
        trait=str(phenomes.traits[idx_trait]),
        entries=entries,
        populations=populations,
        y_true=y,
        y_pred=y_pred,
        metrics=metrics(y, y_pred),
        extras={
            "params": [(np.asarray(W), np.asarray(b)) for W, b in params],
            "x_mean": x_mean,
            "x_std": x_std,
            "y_mean": y_mean,
            "y_std": y_std,
            "hidden_dims": [int(h) for h in hidden_dims],
            "dropout_rate": float(dropout_rate),
            "final_loss": float(losses[-1]),
        },
    )
    if not fit.checkdims():
        raise RuntimeError("error fitting mlp")
    return fit


def mlp_predict_from_fit(fit: Fit, G: np.ndarray) -> np.ndarray:
    """Re-materialize the network from fit.extras and predict rows of G
    (columns already resolved to the fit's loci by the caller)."""
    ex = fit.extras
    Xs = (np.asarray(G, dtype=np.float64) - ex["x_mean"]) / ex["x_std"]
    params = [(jnp.asarray(W), jnp.asarray(b)) for W, b in ex["params"]]
    out = mlp_apply(params, jnp.asarray(Xs, jnp.float32))
    return np.asarray(out, dtype=np.float64) * ex["y_std"] + ex["y_mean"]
