"""Shared setup of the port's training tests: the JAX tests' small width
(tests/test_train.py::_small_cfg) in both packages' configs, JAX's init
and a JAX-built batch."""
import jax
import numpy as np
import torch

from cppf_tpu.config import load_config as load_config_j
from cppf_tpu.data.shapenet import ShapeNetRenderDataset as DatasetJ
from cppf_tpu.train import loop as loop_j
from cppf_tpu.train import step as step_j
from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.train import step

_PARAMS: dict = {}


def _small(cfg, **kw):
    cfg.knn = 12
    cfg.npoint_pad = 512
    cfg.npoint_max = 2000
    cfg.train_pairs = 2048
    cfg.batch_size = 2
    cfg.max_epoch = 2
    cfg.decode_val_every = 0
    cfg.infer_pairs = 2048
    cfg.num_rots = 18
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def small_configs(category="bowl", **kw):
    """(JAX config, port config) of ``category`` at the small width."""
    return _small(load_config_j(category), **kw), _small(load_config(category), **kw)


def jax_params(cfg_j, seed=0):
    """JAX's init_train_state params as nested numpy (jitted: equal to the
    eager init, in a third of the time; kept per head width and seed)."""
    key = (cfg_j.out_dim, cfg_j.knn, cfg_j.npoint_pad, seed)
    if key not in _PARAMS:
        init = jax.jit(lambda k: step_j.init_train_state(k, cfg_j, cfg_j.npoint_pad).params)
        _PARAMS[key] = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    return _PARAMS[key]


def jax_batch(cfg_j, key, n=2, seed=0):
    """``n`` samples of JAX's dataset and JAX's build_batch of them on ``key``."""
    ds = DatasetJ(cfg_j, seed=seed)
    samples = [ds.sample() for _ in range(n)]
    return samples, loop_j.build_batch(cfg_j, key, samples, cfg_j.npoint_pad)


def torch_batch(batch_j):
    """A JAX Batch as the port's, on the CPU."""
    return step.Batch(*(None if a is None else torch.from_numpy(np.array(a)) for a in batch_j))
