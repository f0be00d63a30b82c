"""repro_torch.analysis: standing checks of the port's systems claims
(counterpart of ``repro.analysis``).

The claims (no full-bucket fp32 buffer on the ZeRO-2 path, no optimizer
state gathered back to full size, no update that serializes a later
collective, no defensive copy of a big leaf, launches that fit the card
and cover their operands, the repo's conventions) are checked on the
record of a real step run on meta tensors, not on a device:

* :mod:`repro_torch.analysis.trace`: records one ``make_dp_train_step``
  step per optimizer x engine x wire x accum combo as rank 0 of four,
  through a recording group (the JAX package lowers and parses HLO);
* :mod:`repro_torch.analysis.framework`: findings, the pass registry and
  the runner;
* the passes: :mod:`memory`, :mod:`sharding`, :mod:`overlap`,
  :mod:`donation`, :mod:`kernel_lint`, :mod:`conventions`;
* ``python -m repro_torch.analysis.check --all``: the gate; writes
  ``ANALYSIS_report.json`` and exits 1 on an error.
"""
from repro_torch.analysis.findings import (  # noqa: F401
    Finding, Severity, load_allowlist, report_dict,
)
from repro_torch.analysis.framework import (  # noqa: F401
    AnalysisPass, Artifacts, Combo, pass_catalog, registered_passes,
)
