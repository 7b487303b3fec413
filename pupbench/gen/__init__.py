"""The cell's inputs, made from ``--seed``: the contact map
(``contact_map``), the feature pools (``features``) and the expected table
(``expected``)."""
