"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``): ``sgd``, ``momentum`` and ``adamw`` (with and without
weight decay) take the same given gradients for 5 steps, in float32 and
bfloat16 parameters; every step's updates and parameters after
``apply_updates`` agree to 1e-6 relative (states and updates are float32
in both packages)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim

SHAPES = {"embed": (16, 8), "stages.0.0.attn.wq": (2, 8, 12),
          "final_norm": (8,)}
STEPS, LR = 5, 1e-2
OPTS = {"sgd": ("sgd", {}), "momentum": ("momentum", {}),
        "adamw": ("adamw", {}), "adamw-wd": ("adamw", {"weight_decay": 0.1})}


def _close(port: torch.Tensor, ref, what):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-6,
                               atol=1e-30, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", list(OPTS))
def test_optimizer_steps_match_reference(opt, dtype):
    name, kw = OPTS[opt]
    rng = np.random.default_rng(0)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
    tp = {n: torch.from_numpy(a).to(getattr(torch, dtype))
          for n, a in init.items()}
    jp = {n: jnp.asarray(a).astype(dtype) for n, a in init.items()}
    topt = getattr(toptim, name)(LR, **kw)
    jopt = getattr(joptim.optimizers, name)(LR, **kw)
    ts, js = topt.init(tp), jopt.init(jp)
    for step in range(STEPS):
        g = {n: rng.standard_normal(s).astype(np.float32) * 10.0 ** -step
             for n, s in SHAPES.items()}
        tu, ts = topt.update({n: torch.from_numpy(a).to(getattr(torch, dtype))
                              for n, a in g.items()}, ts, tp)
        ju, js = jopt.update({n: jnp.asarray(a).astype(dtype)
                              for n, a in g.items()}, js, jp)
        tp = toptim.apply_updates(tp, tu)
        jp = joptim.apply_updates(jp, ju)
        for n in SHAPES:
            assert tu[n].dtype == torch.float32
            assert tp[n].dtype == getattr(torch, dtype)
            _close(tu[n], ju[n], f"step {step} update {n}")
            _close(tp[n], jp[n].astype(jnp.float32), f"step {step} param {n}")
    if name == "adamw":
        assert ts.t.dtype == torch.int32 and int(ts.t) == int(js.t) == STEPS
