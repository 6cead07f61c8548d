"""Host-side analyses of the port, and its static gates (dopt's
``dopt.analysis``).

``python -m dopt_torch.analysis.comm_bytes``
    The bytes on the consensus wire of one round of each wire.

``python -m dopt_torch.analysis.lint dopt_torch/``
    Trace-safety & determinism linter — a stdlib-``ast`` pass flagging
    wall-clock reads, global-state RNG, host syncs and data-dependent
    shapes in code captured into a CUDA graph or vmapped, and
    non-deterministic telemetry emission outside ``dopt_torch.obs``.
    Audited legitimate uses carry a ``# dopt: allow-<rule> --
    <justification>`` pragma.

``python -m dopt_torch.analysis.eligibility``
    Eligibility-matrix extractor — harvests every construction-time
    ``raise ValueError`` across the port's config and engine
    constructors into ``dopt_torch/analysis/eligibility.json`` and
    cross-checks the composition rejections against the table in
    ``dopt_torch/ELIGIBILITY.md``.

``python -m dopt_torch.analysis.fingerprint``
    Program-fingerprint registry — runs one round of each canonical
    default config (both engines, tiny CPU sizes), hashes the ATen op
    stream it dispatches and diffs against the committed
    ``dopt_torch/analysis/program_fingerprints.json``; ``--bless
    --reason "..."`` rewrites it with a recorded justification.

The three gates share ``dopt_torch.obs.check``'s conventions: exit 0
clean, 1 findings, 2 usage error; ``--json`` emits machine output
(``dopt_torch.analysis.common``).
"""

from dopt_torch.analysis.common import (EXIT_CLEAN, EXIT_FINDINGS, EXIT_USAGE,
                                        Finding, parse_pragmas)

__all__ = ["EXIT_CLEAN", "EXIT_FINDINGS", "EXIT_USAGE", "Finding",
           "parse_pragmas"]
