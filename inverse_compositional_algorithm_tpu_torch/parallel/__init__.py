"""Scale-out on torch.distributed: pairs over ranks (`sharded`), image rows
over ranks (`tiled`), the torchrun launcher (`launch`), weak scaling and
the multi-rank dry run (`scaling`), and a runner of local ranks (`spawn`).
"""
