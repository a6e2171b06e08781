"""The port's logical-axis placements against the reference's
(``src/repro/models/zoo.py`` sharding half): every parameter's logical
axes, their resolution on the production meshes and a (2, 4) one, the
per-device bytes, and the inputs' and caches' shapes and specs. The
reference's side needs only ``jax.eval_shape`` and a ``MeshInfo``: no
devices and no compile."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS, SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.models import zoo as RZ
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, mesh as M
from repro_torch.models import zoo

STACKED = ("blocks", "enc_blocks", "dec_blocks")
MESHES = {"pod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16)),
          "host_2x4": (("data", "model"), (2, 4))}


def _is_spec(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _flat(tree, layers, prefix=""):
    """The reference's tree as the port's names: each stacked leaf once a
    layer (``blocks.{i}.attn.wq``), its leading "layers" entry dropped."""
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if key in STACKED and not prefix:
            for name, leaf in _flat(val, layers, "@.").items():
                for i in range(layers[key]):
                    out[f"{key}.{i}.{name[2:]}"] = leaf
        elif isinstance(val, dict):
            out.update(_flat(val, layers, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _ref_specs(arch):
    """(config, {name: logical axes}, {name: (shape, itemsize)}, layers)."""
    cfg = r_get_config(arch)
    captured = {}

    def build():
        params, specs = RZ.init_model(jax.random.PRNGKey(0), cfg)
        captured["specs"] = specs
        return params

    params = jax.eval_shape(build)
    layers = {"blocks": cfg.n_layers, "enc_blocks": cfg.n_enc_layers,
              "dec_blocks": cfg.n_layers}
    return cfg, params, captured["specs"], layers


def _ref_leaf_spec(spec):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _shard_bytes(shape, itemsize, spec, sizes):
    n = 1
    for e in spec:
        for a in (e,) if isinstance(e, str) else (e or ()):
            n *= sizes[a]
    return math.prod(shape) * itemsize // n


@pytest.fixture(scope="module", params=ARCH_IDS)
def both(request):
    arch = request.param
    rcfg, rparams, rspecs, layers = _ref_specs(arch)
    cfg = get_config(arch)
    with FakeTensorMode():
        model = zoo.build_model(cfg, torch.device("cpu"))
        shapes = zoo.param_shapes(model)
        specs = zoo.param_specs(cfg, model)
    return arch, rcfg, rparams, rspecs, layers, cfg, shapes, specs


def test_param_specs_are_the_references(both):
    """Every parameter's logical axes from ``param_specs`` equal the
    reference's spec tree (its stacked "layers" axis dropped), matched
    through convert.py's names, and the shapes agree."""
    arch, _, rparams, rspecs, layers, _, shapes, specs = both
    flat = _flat(jax.tree.map(lambda s: s, rspecs, is_leaf=_is_spec), layers)
    flat = {k: v[1:] if k.split(".")[0] in STACKED else v
            for k, v in flat.items()}
    assert flat == specs
    rshapes = _flat(jax.tree.map(lambda a: a, rparams), layers)
    for name, sd in shapes.items():
        want = rshapes[name].shape
        want = want[1:] if name.split(".")[0] in STACKED else want
        assert sd.shape == tuple(want), name
        assert sd.dtype.itemsize == rshapes[name].dtype.itemsize, name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolved_specs_and_bytes_are_the_references(both, mesh):
    """Every resolved spec equals the reference's ``specs_with_dims`` and
    the per-device bytes of the parameters are exactly equal, on both
    production meshes and a (2, 4) one."""
    arch, rcfg, rparams, rspecs, layers, cfg, shapes, specs = both
    names, sizes = MESHES[mesh]
    axis_sizes = dict(zip(names, sizes))
    rinfo = RZ.MeshInfo(axis_names=names, axis_sizes=axis_sizes)
    resolved = RZ.specs_with_dims(rparams, rspecs, rcfg, rinfo,
                                  RZ.policy_for(rcfg))
    rflat = _flat(jax.tree.map(lambda s: s, resolved,
                               is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec)), layers)
    minfo = zoo.MeshInfo(axis_names=names, axis_sizes=axis_sizes)
    got = zoo.specs_with_dims(shapes, specs, cfg, minfo, zoo.policy_for(cfg))
    for name, spec in got.items():
        want = _ref_leaf_spec(rflat[name])
        want = want[1:] if name.split(".")[0] in STACKED else want
        assert spec == want, (name, spec, want)
    ref_bytes = sum(
        _shard_bytes(leaf.shape, leaf.dtype.itemsize,
                     _ref_leaf_spec(spec), axis_sizes)
        for leaf, spec in zip(
            jax.tree.leaves(rparams),
            jax.tree.leaves(resolved, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))))
    port_bytes = sum(sd.nbytes // minfo.shards(got[k])
                     for k, sd in shapes.items())
    assert port_bytes == ref_bytes


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inputs_and_caches_are_the_references(arch, shape):
    """``batch_shapes``, ``batch_specs``, the decode cache's shapes and its
    specs (logical and resolved on the pod mesh) equal the reference's,
    at the cache length the dry run uses."""
    rcfg, cfg = r_get_config(arch), get_config(arch)
    rshape, pshape = R_SHAPES[shape], SHAPES[shape]
    assert (pshape.name, pshape.seq_len, pshape.global_batch,
            pshape.kind) == (rshape.name, rshape.seq_len,
                             rshape.global_batch, rshape.kind)
    for names, sizes in MESHES.values():
        info = dict(axis_names=names, axis_sizes=dict(zip(names, sizes)))
        rb = RZ.batch_specs(rcfg, rshape, RZ.MeshInfo(**info))
        pb = zoo.batch_specs(cfg, pshape, zoo.MeshInfo(**info))
        assert {k: _ref_leaf_spec(v) for k, v in rb.items()} == pb
    rb = RZ.batch_shapes(rcfg, rshape)
    pb = zoo.batch_shapes(cfg, pshape)
    assert set(rb) == set(pb)
    for k, v in rb.items():
        assert pb[k].shape == v.shape
        assert pb[k].dtype.itemsize == np.dtype(v.dtype).itemsize
        assert pb[k].dtype.is_floating_point == jnp.issubdtype(
            v.dtype, jnp.floating)
    assert zoo.cache_specs(cfg) == RZ.cache_specs(rcfg)
    length = dryrun.decode_cache_len(cfg, pshape)
    rcache = jax.eval_shape(lambda: RZ.init_cache(
        rcfg, rshape.global_batch, length))
    with FakeTensorMode():
        cache = zoo.init_cache(cfg, pshape.global_batch, length,
                               device="cpu")
        pcache = {k: zoo.ShapeDtype(tuple(v.shape), v.dtype)
                  for k, v in cache.items()}
    assert {k: v.shape for k, v in rcache.items()} == {
        k: v.shape for k, v in pcache.items()}
    names, sizes = MESHES["pod"]
    info = dict(axis_names=names, axis_sizes=dict(zip(names, sizes)))
    rres = RZ.specs_with_dims(rcache, RZ.cache_specs(rcfg), rcfg,
                              RZ.MeshInfo(**info), RZ.policy_for(rcfg))
    pres = zoo.specs_with_dims(pcache, zoo.cache_specs(cfg), cfg,
                               zoo.MeshInfo(**info), zoo.policy_for(cfg))
    assert {k: _ref_leaf_spec(v) for k, v in rres.items()} == pres


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(multi_pod):
    """``make_production_mesh`` over a fake group of 256 or 512 ranks and
    ``mesh_info`` give the reference's axes; ``placements`` turns a
    resolved spec into DTensor placements on it."""
    from torch.distributed.tensor import Replicate, Shard
    n = 512 if multi_pod else 256
    with M.fake_world(n):
        mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        info = M.mesh_info(mesh)
        assert info.batch_size_total * info.model_size == n
        assert info.model_size == 16
        assert info.batch_axes == (("pod", "data") if multi_pod
                                   else ("data",))
        spec = (info.batch_axis(), None, "model")
        got = zoo.placements(spec, mesh)
        assert got == ((Shard(0),) * len(info.batch_axes) + (Shard(2),))
        assert zoo.placements((None, None), mesh) == (Replicate(),) * \
            mesh.ndim
        with pytest.raises(RuntimeError, match="already"):
            with M.fake_world(2):
                pass
        host = M.make_host_mesh(4, device_type="cpu")
        assert tuple(host.shape) == (n // 4, 4)


def test_unknown_logical_axis_and_parameter_raise():
    cfg = get_config("smollm_135m")
    info = zoo.MeshInfo(axis_names=("data", "model"),
                        axis_sizes={"data": 2, "model": 4})
    with pytest.raises(ValueError, match="logical axis"):
        zoo.resolve_specs(("nope",), cfg, info, zoo.policy_for(cfg))
    with pytest.raises(ValueError, match="no logical axes"):
        zoo._param_spec("blocks.0.attn.zz")
