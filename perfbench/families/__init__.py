"""Model families, the program's side: `families/<family>.py` builds the
port's model for a configuration whose `family` names it (`spec.family`).
A new architecture adds this file with `reference/<family>.py` and
`counts/<family>.py`, and edits none that is there."""
