"""Training runtime: the train-step factories (:mod:`.step`), checkpoints
(:mod:`.checkpoint`) and the step watchdog with the restart policy
(:mod:`.fault`)."""
