"""Shared fixture helper of the ``test_torch_*`` files: one small GPT-2 in
both packages with the same weights (JAX-initialised, moved into the port
through ``params_from_jax``)."""

import jax
import jax.numpy as jnp

from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow.models.gpt2 import GPT2Config as JConfig
from tpuflow_torch.models.convert import params_from_jax
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config


def jax_and_port_gpt2(**kw):
    """``(jax_model, jax_params, port_model)`` at ``small_test`` sizes with
    dropout off; ``kw`` goes to both configs, except ``scan_layers``, which
    only changes the JAX param layout (the port reads either)."""
    kw = {"n_ctx": 64, "dropout": 0.0, **kw}
    jm = JGPT2(JConfig.small_test(**kw))
    kw.pop("scan_layers", None)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    tm = GPT2(GPT2Config.small_test(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    return jm, params, tm
