"""Training of the port: the data stream (:mod:`.data`), AdamW
(:mod:`.optimizer`), checkpoints (:mod:`.checkpoint`) and the train loop
(:mod:`.train_loop`), eager torch on the card or the CPU."""
