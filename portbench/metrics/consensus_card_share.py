"""consensus_card_share: the share of MAM correction's member rows that the
consensus chain voted on, in %: the engine counters consensus_rows_card
over consensus_rows_card + consensus_rows_host (the rows of the other
partitions of more than one member, which the host takes), summed over the
window's jobs at their ends; nothing where the engine keeps no such
counter or no partition of more than one member was corrected."""


def read(run):
    if not run.jobs or "consensus_rows_card" not in run.jobs[0].counters_end:
        return None
    card = sum(j.counters_end["consensus_rows_card"] for j in run.jobs)
    rows = card + sum(j.counters_end["consensus_rows_host"] for j in run.jobs)
    if not rows:
        return None
    return 100.0 * card / rows
