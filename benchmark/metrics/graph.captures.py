"""CUDA graphs captured in the window: the count of its ``graph.capture``
spans (``FLAC_TPU_TRACE``), 0 where there are none.  Nothing where the
window holds no ``decode.read`` span: a program that does not span its
reads does not span its captures either."""


def read(data):
    spans = data["spans"]
    if "decode.read" not in spans:
        return None
    return len(spans.get("graph.capture", []))
