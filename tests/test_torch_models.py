"""The GNN policies of the PyTorch port against the JAX package's
``models/gnn.py`` on the CPU.

Flax weights go across through ``convert.gnn_params_from_flax``; inputs are
made with numpy from a seed, as f32, and fed to both.  The JAX large model
runs its Pallas aggregation in interpret mode.  Tolerance: the actions to
1e-5 (absolute and relative).
"""
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gym_flock_tpu.models import gnn as jgnn
from gym_flock_tpu.ops import sparse_flocking as jsf
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.models import AggregationGNN, LargeAggregationGNN
from gym_flock_tpu_torch.models.gnn import lecun_normal_
from gym_flock_tpu_torch.ops import sparse_flocking as sf

torch.set_num_threads(2)

CR2 = 0.81
TOL = 1e-5


def swarm(b, n, seed, spread):
    x = np.random.RandomState(seed).standard_normal((b, n, 4)).astype(np.float32)
    x[..., :2] *= spread
    return x


def feats(b, n, seed):
    """Observation-like features: 1/r^4-scale channels among O(1) ones."""
    f = np.random.RandomState(seed).standard_normal((b, n, 6)).astype(np.float32)
    f[..., 1] *= 1e3
    return f


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def mean_pooled_adjacency(x):
    d = x[:, :, None, :2] - x[:, None, :, :2]
    r2 = (d * d).sum(-1)
    n = x.shape[1]
    adj = ((r2 < CR2) & ~np.eye(n, dtype=bool)).astype(np.float32)
    deg = adj.sum(-1, keepdims=True)
    return adj / np.where(deg == 0, 1.0, deg)


@pytest.mark.parametrize("k_hops,hidden,squash", [(3, (64, 64), True), (2, (16,), False)])
def test_aggregation_gnn_equals_flax(k_hops, hidden, squash):
    x = swarm(3, 20, 0, spread=1.0)
    f, adj = feats(3, 20, 1), mean_pooled_adjacency(x)
    jmodel = jgnn.AggregationGNN(k_hops=k_hops, hidden=hidden, squash_inputs=squash)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(f[0]), jnp.asarray(adj[0]))
    want = jax.vmap(lambda a, b: jmodel.apply(variables, a, b))(jnp.asarray(f), jnp.asarray(adj))
    model = convert.gnn_params_from_flax(
        variables, AggregationGNN(k_hops=k_hops, hidden=hidden, squash_inputs=squash))
    got = model(t(f), t(adj))
    assert got.shape == (3, 20, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("aggregation", ["dense", "sparse"])
def test_large_aggregation_gnn_equals_flax(aggregation):
    n = 48 if aggregation == "dense" else 256
    x, f = swarm(2, n, 2, spread=1.5), feats(2, n, 3)
    if aggregation == "dense":
        jmodel = jgnn.LargeAggregationGNN(comm_radius2=CR2, interpret=True)
        model = LargeAggregationGNN(comm_radius2=CR2)
    else:
        jmodel = jgnn.LargeAggregationGNN(
            comm_radius2=CR2,
            aggregate_fn=functools.partial(jsf.khop_aggregate_sparse, comm_radius2=CR2,
                                           k_hops=3))
        model = LargeAggregationGNN(
            comm_radius2=CR2,
            aggregate_fn=functools.partial(sf.khop_aggregate_sparse, comm_radius2=CR2,
                                           k_hops=3))
    variables = jmodel.init(jax.random.key(1), jnp.asarray(x[0]), jnp.asarray(f[0]))
    want = jax.vmap(lambda a, b: jmodel.apply(variables, a, b))(jnp.asarray(x), jnp.asarray(f))
    got = convert.gnn_params_from_flax(variables, model)(t(x), t(f))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_conversion_rejects_other_widths():
    jmodel = jgnn.AggregationGNN(hidden=(32,))
    variables = jmodel.init(jax.random.key(0), jnp.zeros((5, 6), jnp.float32),
                            jnp.zeros((5, 5), jnp.float32))
    with pytest.raises(ValueError):
        convert.gnn_params_from_flax(variables, AggregationGNN(hidden=(64,)))
    with pytest.raises(ValueError):
        convert.gnn_params_from_flax(variables, AggregationGNN(hidden=(32, 32)))


def test_init_has_flax_statistics():
    """Per layer: kernels of mean 0 and std sqrt(1/fan_in), cut at two
    standard deviations of the untruncated normal, as flax's; biases 0."""
    hidden = (256, 256)
    jmodel = jgnn.AggregationGNN(hidden=hidden)
    variables = jmodel.init(jax.random.key(2), jnp.zeros((5, 6), jnp.float32),
                            jnp.zeros((5, 5), jnp.float32))
    model = AggregationGNN(hidden=hidden, generator=torch.Generator().manual_seed(2))
    dense = variables["params"]["_MLP_0"]
    for i, layer in enumerate(model.mlp.layers):
        w = layer.weight.detach().numpy().ravel()
        jw = np.asarray(dense[f"Dense_{i}"]["kernel"]).ravel()
        fan_in = layer.weight.shape[1]
        std = np.sqrt(1.0 / fan_in)
        cut = 2.0 * std / 0.87962566103423978
        for sample in (w, jw):
            # the sample std of n draws lies within 5 of its standard errors
            assert abs(sample.std() / std - 1.0) < 5.0 / np.sqrt(2 * sample.size)
            assert abs(sample.mean()) < 5.0 * std / np.sqrt(sample.size)
            assert np.abs(sample).max() <= cut * (1 + 1e-6)
        assert not layer.bias.detach().any()
        assert not np.asarray(dense[f"Dense_{i}"]["bias"]).any()


def test_init_draws_from_the_generator():
    a = AggregationGNN(generator=torch.Generator().manual_seed(5))
    b = AggregationGNN(generator=torch.Generator().manual_seed(5))
    c = AggregationGNN(generator=torch.Generator().manual_seed(6))
    for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb)
        if pa.dim() == 2:
            assert not torch.equal(pa, pc)


def test_lecun_normal_truncates_at_two_standard_deviations():
    w = torch.empty(4000, 50)
    lecun_normal_(w, torch.Generator().manual_seed(0))
    z = (w * np.sqrt(50) * 0.87962566103423978).numpy()
    assert np.abs(z).max() <= 2.0 + 1e-5
    # the mass beyond |z| = 1 of the standard normal truncated to [-2, 2]
    beyond = 1.0 - math.erf(1.0 / math.sqrt(2.0)) / math.erf(2.0 / math.sqrt(2.0))
    assert abs((np.abs(z) > 1.0).mean() - beyond) < 0.01
