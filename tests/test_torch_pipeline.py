"""The GPipe forward of parallel/pipeline.py against the JAX package's: the
stage split and merge, the indivisible-layers error, the (pipe, model)
mesh's construction and refusals, and ``pipelined_decoder_forward`` on the
same f32 weights as JAX's (its ``shard_map`` over 2 virtual CPU devices;
the port's stages on a mesh of ``cpu`` devices), with autograd's
gradients through the stage copies equal to the unpipelined forward's.

Tolerances: f32 on both sides, other summation orders: 2e-4, JAX's own
bound for its pipelined forward; the port's pipelined and unpipelined
forwards run the same operations a microbatch, so their gradients agree
within 1e-5 (a matmul's rows are not bitwise independent of the row
count)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.parallel import pipeline as jpipe
from generativeaiexamples_tpu.parallel.mesh import create_mesh as jcreate_mesh
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models.convert import params_from_jax
from generativeaiexamples_tpu_torch.parallel import create_mesh, pipeline

JCFG = jl.PRESETS["debug"]  # 2 layers
TCFG = tl.PRESETS["debug"]
ATOL = 2e-4


def _tokens(B, T, seed=0):
    return np.random.default_rng(seed).integers(1, JCFG.vocab_size, (B, T)).astype(np.int32)


def test_split_merge_roundtrip_and_the_indivisible_error():
    layers = [{"wq": torch.full((2,), float(i))} for i in range(4)]
    staged = pipeline.split_stages(layers, 2)
    assert [[lp["wq"][0].item() for lp in stage] for stage in staged] == [[0, 1], [2, 3]]
    assert pipeline.merge_stages(staged) == layers
    jlayers = {"wq": jnp.arange(4.0)[:, None]}
    with pytest.raises(ValueError) as want:
        jpipe.split_stages(jlayers, 3)
    with pytest.raises(ValueError) as got:
        pipeline.split_stages(layers, 3)
    assert str(got.value) == str(want.value) == "4 layers not divisible by 3 stages"


@pytest.mark.parametrize("n,tp,pp", [(8, -1, 2), (8, 2, 2), (8, -1, 3), (4, 2, 4), (6, 3, 2),
                                      (8, 1, 8), (2, 1, 1)])
def test_create_mesh_with_a_pipe_axis_is_jax_s(n, tp, pp):
    """The pipe axis outermost, stage s over devices[s*tp:(s+1)*tp]; JAX's
    messages where the devices do not divide or do not suffice."""
    devices = [torch.device("cpu", i) for i in range(n)]
    try:
        want = jcreate_mesh(tensor_parallelism=tp, pipeline_parallelism=pp,
                            devices=jax.devices()[:n])
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            create_mesh(tp, pipeline_parallelism=pp, devices=devices)
        assert str(got.value) == str(exc)
        return
    mesh = create_mesh(tp, pipeline_parallelism=pp, devices=devices)
    shape = dict(want.shape)
    assert mesh.pipe == shape["pipe"] and mesh.tp == shape["model"]
    assert mesh.shape == shape
    order = [d.id for d in want.devices.reshape(-1)]
    assert [d.index for d in mesh.devices] == order
    for s in range(mesh.pipe):
        assert [d.index for d in mesh.stage(s).devices] == order[s * mesh.tp:(s + 1) * mesh.tp]


def test_pipelined_forward_matches_jax_s():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tokens = _tokens(4, 8)
    jmesh = jcreate_mesh(tensor_parallelism=1, pipeline_parallelism=2, devices=jax.devices()[:2])
    want = jpipe.pipelined_decoder_forward(jparams, JCFG, jnp.asarray(tokens), jmesh, n_stages=2,
                                           n_microbatches=2)
    mesh = create_mesh(1, pipeline_parallelism=2, devices=["cpu"] * 2)
    params = params_from_jax(jparams)
    staged = pipeline.shard_stages(pipeline.split_stages(params["layers"], 2), mesh)
    got = pipeline.pipelined_decoder_forward(params, TCFG, torch.from_numpy(tokens).long(), mesh,
                                             n_stages=2, n_microbatches=2, staged_layers=staged)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
    with pytest.raises(ValueError, match="batch 4 not divisible by 3 microbatches"):
        pipeline.pipelined_decoder_forward(params, TCFG, torch.from_numpy(tokens).long(), mesh,
                                           n_stages=2, n_microbatches=3)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_pipelined_gradients_equal_the_unpipelined_forward_s(microbatches):
    """Autograd through the stage copies: the loss and every weight's
    gradient equal those of ``llama.forward`` on the same batch."""
    torch.manual_seed(microbatches)
    base = tl.init_params(TCFG, seed=1, dtype=torch.float32)
    tokens = torch.from_numpy(_tokens(4, 8, seed=microbatches)).long()
    positions = torch.arange(8).expand(4, 8)
    mesh = create_mesh(1, pipeline_parallelism=2, devices=["cpu"] * 2)

    def grads(fn):
        params = {k: (v if k != "layers" else [{n: t.clone().requires_grad_(True)
                                                for n, t in lp.items()} for lp in v])
                  for k, v in base.items()}
        params = {k: (v.clone().requires_grad_(True) if k != "layers" else v)
                  for k, v in params.items()}
        loss = (fn(params) ** 2).mean()
        loss.backward()
        return loss.item(), params

    loss_p, got = grads(lambda p: pipeline.pipelined_decoder_forward(
        p, TCFG, tokens, mesh, n_stages=2, n_microbatches=microbatches))
    loss_r, want = grads(lambda p: tl.forward(p, TCFG, tokens, positions))
    assert abs(loss_p - loss_r) <= 1e-6 * abs(loss_r)
    for lg, lw in zip(got["layers"], want["layers"]):
        for name in lw:
            np.testing.assert_allclose(lg[name].grad.numpy(), lw[name].grad.numpy(), atol=1e-5,
                                       err_msg=name)
    np.testing.assert_allclose(got["embed"].grad.numpy(), want["embed"].grad.numpy(), atol=1e-5)
    assert float(got["layers"][0]["wq"].grad.abs().sum()) > 0
