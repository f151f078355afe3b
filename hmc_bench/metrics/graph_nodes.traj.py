"""Kernel nodes of the captured trajectory graph (the program's count)."""


def read(ctx):
    graph = (ctx.result.perf or {}).get("graph") or {}
    return graph.get("kernel_nodes")
