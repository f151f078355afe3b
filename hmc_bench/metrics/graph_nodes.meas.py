"""Kernel nodes of the captured measurement graph (the program's count)."""


def read(ctx):
    graph = (ctx.result.perf or {}).get("measurement_graph") or {}
    return graph.get("kernel_nodes")
