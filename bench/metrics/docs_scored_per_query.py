"""Documents a query scores (``TopK``'s ``n_scored_docs``), mean over
the window's queries: the admission at the segment level."""


def read(rec: dict):
    n_q = sum(rec["batches"]["n_q"])
    return sum(rec["batches"]["scored_docs"]) / n_q if n_q else None
