"""Mean device ms of the DHR head a batch over the window: the tower's
``reps`` (MLM logits, softmax, term weighting, the max over positions, the
CLS projection) plus the ``Encoder``'s ``planes`` (densify to (value,
fold), the f16 / uint8 casts), from CUDA events around each call."""


def read(run):
    head = run.spans.get("encode.head")
    planes = run.spans.get("encode.densify")
    if not head or not planes or len(head) != len(planes):
        return None
    return (sum(head) + sum(planes)) / len(head)
