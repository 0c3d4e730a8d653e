"""One module per entry of the program that a traffic mix drives, found by
the name in the traffic file's ``entry``: ``run`` drives the entry once and
``price`` counts the job's work from the algorithm's sizes."""
