from repro_torch.data.pipeline import SyntheticLM, TokenFileDataset, make_dataset  # noqa: F401
