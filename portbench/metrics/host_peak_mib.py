"""host_peak_mib: the benchmark process's peak resident memory on the
host, in MiB, over its set-up and its window (``getrusage``'s
``ru_maxrss``, read as the window closes, before the check runs the
reference): the host memory that a report holds, with the corpus store's
shards mapped."""

import resource


def read(ctx):
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
