"""The wave's merge: the threshold-filtered top-k of one wave's scores
joined with the running top-k (``ops.merge_topk``, and its plain version
``ref.merge_wave_ref``)."""
