"""Generation (``generate``, ``beam_search``, ``speculative_generate``),
scoring (``sequence_logprob``, ``best_of_n``), int8 (``quant``: weight-only
and fused-native), the paged continuous-batching engine and its long-lived
loop (``serve``: ``ServeEngine``, ``serve_forever``), the replica's
``/generate`` gateway (``frontdoor``) and batch prediction over rows
(``engine``)."""

from tpuflow_torch.infer.beam import beam_search
from tpuflow_torch.infer.engine import (
    BatchPredictor,
    GenerationPredictor,
    map_batches,
)
from tpuflow_torch.infer.generate import generate, pad_ragged, render_tokens
from tpuflow_torch.infer.quant import (
    QuantDecision,
    QuantizedModel,
    dequantize_params,
    maybe_quantize,
    quant_decision,
    quantize_model,
    quantize_params,
    teacher_forced_agreement,
)
from tpuflow_torch.infer.score import best_of_n, sequence_logprob
from tpuflow_torch.infer.serve import ServeEngine, ServeRequest, serve_forever
from tpuflow_torch.infer.speculative import speculative_generate

__all__ = [
    "BatchPredictor",
    "GenerationPredictor",
    "ServeEngine",
    "ServeRequest",
    "QuantDecision",
    "QuantizedModel",
    "beam_search",
    "best_of_n",
    "dequantize_params",
    "generate",
    "map_batches",
    "maybe_quantize",
    "pad_ragged",
    "quant_decision",
    "quantize_model",
    "quantize_params",
    "render_tokens",
    "sequence_logprob",
    "serve_forever",
    "speculative_generate",
    "teacher_forced_agreement",
]
