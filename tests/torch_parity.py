"""Shared helpers of the ``test_torch_*`` files: one small GPT-2 in both
packages with the same weights (JAX-initialised, moved into the port
through ``params_from_jax``), and a fixture that keeps a module's torch
ops on one thread."""

import jax
import jax.numpy as jnp
import pytest
import torch

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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The importing module's torch ops on one intra-op thread, the count
    restored after it. The suite runs in several worker processes, and
    torch's default of one OpenMP thread per core in each of them
    oversubscribes the CPU, the threads' spin-waits starving the other
    workers. These small models gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
