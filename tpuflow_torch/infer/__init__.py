"""Generation (``generate``), fused-native int8 (``quant``) and the paged
continuous-batching engine (``serve``)."""
