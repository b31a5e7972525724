"""The flow layer (counterpart of ``tpuflow/flow``).

Authoring: ``FlowSpec``, ``@step``, ``Parameter``, ``current``; the
decorators ``@retry``, ``@gpu`` (gang), ``@kubernetes``, ``@pypi``,
``@card``, ``@device_profile``, ``@schedule``, ``@trigger_on_finish``; the
client ``Run``/``Task``/``Flow`` and the namespace; the card components
``Markdown``/``Table``/``Image`` and the charts. Execution semantics are
in ``tpuflow_torch.flow.runner``; the store's layout is the JAX
package's (``tpuflow_torch.flow.store``).
"""

from tpuflow_torch.flow.cards import (
    BarChart,
    CardBuffer,
    Image,
    LineChart,
    Markdown,
    Table,
    metrics_table,
    training_curve_card,
)
from tpuflow_torch.flow.client import (
    Flow,
    Run,
    Task,
    default_namespace,
    get_namespace,
    namespace,
)
from tpuflow_torch.flow.decorators import (
    card,
    device_profile,
    gpu,
    kubernetes,
    pypi,
    retry,
    schedule,
    trigger_on_finish,
)
from tpuflow_torch.flow.spec import FlowSpec, Parameter, current, step

__all__ = [
    "BarChart",
    "CardBuffer",
    "Flow",
    "FlowSpec",
    "Image",
    "LineChart",
    "Markdown",
    "Parameter",
    "Run",
    "Table",
    "Task",
    "card",
    "current",
    "default_namespace",
    "device_profile",
    "get_namespace",
    "gpu",
    "kubernetes",
    "metrics_table",
    "namespace",
    "pypi",
    "retry",
    "schedule",
    "step",
    "training_curve_card",
    "trigger_on_finish",
]
