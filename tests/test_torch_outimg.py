"""The decode head's OutImg on the port's two plain-torch head paths,
against the JAX decodes, with ``out_bias="sigmoid"``: every JAX decode
applies tanh * 0.5 + 0.5 to the head whatever ``cfg.out_bias`` is
(boosting_nerv_tpu/runtime/fast_decode.py:204-207, :308-310 and
:1060-1064), and so must the port.

- v5 on a config whose last stage has stride 2: the head runs in torch on
  the planar tail's output (JAX v5 in Pallas interpret mode);
- v3 and v2 with ``tile_from_h`` above the frame height: no stage reaches
  the fine-grid tail and the whole decode runs in torch.

Weights come from a numpy seed and reach both packages through
``bridge.torch_state_from_flax``.  Tolerance: 2e-2 max abs on frames in
[0, 1] (both sides in bf16); the flax decode, which does apply sigmoid,
stands more than 5e-2 away from the JAX frame, so the comparison tells the
two squashings apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.runtime import fast_decode as port_fd
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.runtime import fast_decode as jax_fd

from test_torch_serving import TINY, _cfgs, _flax_params

TOL = 2e-2
APART = 5e-2
NO_FINE = 10 ** 6   # tile_from_h above every stage height


def _v5(jcfg, params):
    return jax_fd.build_fast_decode_v5(jcfg, params, planar_from_h=1, th=4,
                                       interpret=True)


def _port_v5(cfg, state):
    return port_fd.build_fast_decode_v5(cfg, state, planar_from_h=1)


CASES = {
    # last stage stride 2: the head follows the planar tail, in torch
    "v5_stride2_final": (dict(dec_blks=[1, 1]), [(_v5, _port_v5)]),
    # no stage reaches tile_from_h: v3 and v2 decode in torch alone
    "v3_v2_no_fine_stage": ({}, [
        (lambda j, p: jax_fd.build_fast_decode_v3(
            j, p, tile_from_h=NO_FINE, interpret=True),
         lambda c, s: port_fd.build_fast_decode_v3(c, s,
                                                   tile_from_h=NO_FINE)),
        (lambda j, p: jax_fd.build_fast_decode_v2(
            j, p, tile_from_h=NO_FINE, interpret=True),
         lambda c, s: port_fd.build_fast_decode_v2(c, s,
                                                   tile_from_h=NO_FINE))]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_head_is_tanh_outimg_whatever_out_bias(case):
    over, builders = CASES[case]
    cfg, jcfg = _cfgs(TINY, out_bias="sigmoid", **over)
    fmodel = build_flax_model(jcfg)
    params = _flax_params(fmodel, seed=11)
    r = np.random.default_rng(12)
    embed = r.normal(size=(1, 4, 4, 4)).astype(np.float32)
    t = np.array([0.6], np.float32)
    flax_sigmoid = np.asarray(fmodel.apply(
        params, jnp.asarray(embed), jnp.asarray(t), method="decode"))
    state = torch_state_from_flax(params, cfg)
    for jax_build, port_build in builders:
        want = np.asarray(jax_build(jcfg, params)(
            jnp.asarray(embed), jnp.asarray(t)).astype(jnp.float32))
        dec = port_build(cfg, state)
        got = dec(torch.from_numpy(embed), torch.from_numpy(t))
        got = got.float().numpy()
        assert got.shape == want.shape == (1, 16, 16, 3)
        assert np.abs(got - want).max() < TOL
        assert np.abs(flax_sigmoid - want).max() > APART
