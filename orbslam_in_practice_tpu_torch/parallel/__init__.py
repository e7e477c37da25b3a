"""Distributed bundle adjustment over ``torch.distributed``: landmark shards
over ranks, the reduced camera system summed by ``all_reduce``."""
