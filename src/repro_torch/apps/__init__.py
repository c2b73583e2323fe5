"""The paper's seven applications (GPTPU §7): the port of ``repro.apps``.
Each runs its GPTPU (Tensorizer-quantized) implementation on a device and an
fp64 numpy reference, and reports the paper's accuracy metrics (MAPE / RMSE,
Table 4).

Registry: ``apps.ALL`` — name -> run(n, quantized=..., device=...).
"""

from repro_torch.apps.common import ALL, AppResult, mape, rmse_pct, run_app  # noqa: F401
from repro_torch.apps import backprop, blackscholes, gaussian, gemm_app, hotspot3d, lud, pagerank  # noqa: F401
