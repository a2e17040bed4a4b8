"""Static analysis over the traced train step, and the port's lint rules.

Port of `eventgrad_tpu/analysis/`. Each layer imports on its own:

  * `walker` — traces the rank-stacked step into an ATen
    `torch.fx.GraphModule` (`make_fx`, the counterpart of
    `jax.make_jaxpr`) and counts its nodes: `iter_nodes`, `count_ops`,
    `op_census`, `count_full_ravels`.
  * `kernels` — the registry of the port's kernel operators (`eg::`
    ops): each entry declares how the rank dimension enters the kernel;
    an unregistered kernel is a rank-flow violation.
  * `rankflow` — a dataflow over the ATen graph proving rank isolation:
    every value carries which dimension holds the rank (pure, or merged
    rank-major or rank-minor into another dimension), and the only ops
    that move data across ranks are rolls of the rank dimension by a
    topology offset (`collectives.recv_from`), recorded as exchanges.
  * `audit` — the per-configuration auditor: rank isolation, wire-byte
    truth (bytes derived from the exchanged lanes == the accounting
    formula == the step's `sent_bytes_wire_real`), step hygiene, and
    seeded oracle violations proving each check can fire. It holds the
    seeded unregistered kernel (`eg::leak_kernel`,
    `csrc/audit_leak.cu`).

`lint` is the AST lint of the port's sources. Submodules import
explicitly (`from eventgrad_tpu_torch.analysis import lint`), so the lint
never pays the auditor's import chain.
"""
