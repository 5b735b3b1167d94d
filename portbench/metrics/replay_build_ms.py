"""Mean wall time of building one replay's simulator (fresh simulator and
policy, hosts and VMs wired in), the benchmark's own span around it."""


def read(rec):
    if not rec.build_s:
        return None
    return 1e3 * sum(rec.build_s) / len(rec.build_s)
