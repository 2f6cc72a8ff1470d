"""Host set-up of the CH operator (``apps/cahn_hilliard.make_assembled_step``:
``assemble_divgrad``, ``ell_spgemm`` for D², ``ell_add``): host seconds of
the program's ``ch.assemble`` span."""

from portbench.program_spans import setup_seconds


def read(run):
    return setup_seconds(run, "ch.assemble")
