"""Generation (``generate``), fused-native int8 (``quant``), the paged
continuous-batching engine (``serve``) and batch prediction over rows
(``engine``)."""
