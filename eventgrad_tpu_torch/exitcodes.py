"""Process exit codes of the port's training runs.

Port of `eventgrad_tpu/exitcodes.py`, the exit-code contract between a
training child and a supervisor that relaunches it: one import-bare
module, because the codes cross processes.

  * 0                        — the run completed.
  * ``PREEMPTED_EXIT``       — graceful preemption: the child drained,
    snapshotted and exited on purpose; relaunch at once (75, sysexits.h
    EX_TEMPFAIL). A run exits with it on `chaos.GracefulPreemption`
    (a SIGTERM/SIGINT or a `preempt=` notice; `utils/crash_matrix.py`'s
    children do).
  * ``INTEGRITY_ABORT_EXIT`` — the divergence sentinel tripped beyond
    the rollback budget (`chaos/integrity.py`): a relaunch would restore
    the same last-known-good state and replay the same divergence, so
    it is permanent.
  * ``CRASHPOINT_EXIT``      — an armed crash drill fired
    (`chaos/crashpoint.py`'s `os._exit`).
  * ``FAULT_INJECT_EXIT``    — the `fault_inject="crash:N"` drill
    (`train(fault_inject=...)`, the CLI's `--fault-inject`) killed the
    run after epoch N's snapshot; the JAX loop's code, which the
    supervisor treats as any crash.
  * anything else nonzero    — a crash.
"""

#: graceful preemption: relaunch immediately, charge nothing
PREEMPTED_EXIT = 75

#: integrity engine gave up (divergence sentinel beyond max_rollbacks):
#: permanent — restarting would replay the same divergence
INTEGRITY_ABORT_EXIT = 77

#: an armed crash drill killed the process on purpose
CRASHPOINT_EXIT = 83

#: the fault_inject="crash:N" drill killed the process on purpose (the
#: JAX loop spells it by value; kept out of the name table, which is the
#: JAX module's, so the exit-code lint does not claim every literal 13)
FAULT_INJECT_EXIT = 13

#: name table for logs
EXIT_CODE_NAMES = {
    PREEMPTED_EXIT: "PREEMPTED",
    INTEGRITY_ABORT_EXIT: "INTEGRITY_ABORT",
    CRASHPOINT_EXIT: "CRASHPOINT",
}
