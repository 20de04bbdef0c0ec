"""The program's span `densify/knn` (`train.refresh_knn` after a densify
round), host ms a round; None when the traced slice holds no round."""


def read(tr):
    return tr.per_call_ms('densify/knn')
