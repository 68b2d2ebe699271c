"""Share of the host post slices' run time that their threads spent on
a CPU (`host_post.run.cpu` over `host_post.run`), in %: the rest is
waiting for the GIL, a lock or a core."""


def read(m):
    run = m["stats_seconds"].get("host_post.run", 0.0)
    if run <= 0 or "host_post.run.cpu" not in m["stats_counts"]:
        return None
    return 100.0 * m["stats_seconds"]["host_post.run.cpu"] / run
