"""Training runtime: the train-step factories (:mod:`repro_torch.train.step`)."""
