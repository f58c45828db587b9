"""sketch_profile_card_share: the share of the sketch's rows whose hashed
k-mer profiles were built on the card (graph/sketch.py::approximate_matches,
the kernel kmer_profile), in %: the engine counter sketch_profile_card_rows
over sketch_rows, summed over the window's jobs at their ends; nothing
where the engine keeps no such counter or no sketch ran."""


def read(run):
    if not run.jobs or any("sketch_profile_card_rows" not in j.counters_end
                           for j in run.jobs):
        return None
    rows = sum(j.counters_end["sketch_rows"] for j in run.jobs)
    if not rows:
        return None
    card = sum(j.counters_end["sketch_profile_card_rows"] for j in run.jobs)
    return 100.0 * card / rows
