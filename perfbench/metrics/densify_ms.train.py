"""The harness's span around each densify round and its `refresh_knn`,
host ms a round; None when the traced slice holds no round."""


def read(tr):
    return tr.per_call_ms('bench/densify')
