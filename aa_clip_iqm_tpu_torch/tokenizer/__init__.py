from .bpe import ClipTokenizer, tokenize, tokenize_padded  # noqa: F401
