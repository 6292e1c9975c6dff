"""Plain versions of flash attention: the chunked online-softmax form and the
quadratic form."""
from repro_torch.models.attention import chunked_attention, reference_attention  # noqa: F401
