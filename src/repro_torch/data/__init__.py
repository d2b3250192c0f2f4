from repro_torch.data.synthetic import ImageClassData, TokenStream

__all__ = ["ImageClassData", "TokenStream"]
