"""% roofline over the module sites that the port's hand-written kernels
serve (the configuration's `kernel_sites`): the sum of each site's bound
(lib/flops.py) over the sum of its device time, found by site range and
not by kernel name. A configuration with no sites has nothing to read; a
site the trace never entered fails the run, since the share would then
cover less work than the list freezes."""


def read(ctx):
    sites = [s for group in ctx.cell.cfg.get("kernel_sites", {}).values()
             for s in group]
    if not sites:
        return None
    missing = [s for s in sites if ctx.summary.by_site.get(s, 0) <= 0]
    if missing:
        raise RuntimeError(f"kernel sites with no device time: {missing}")
    bound_us = sum(ctx.site_bound_s(s) * 1e6 for s in sites) * ctx.units
    return 100.0 * bound_us / sum(ctx.summary.by_site[s] for s in sites)
