"""Console banner: the reference greets with an ASCII train (misc.py:9-18,
print_choochoo); the port's rides rails of its own."""


def print_choochoo(version: str) -> None:
    print(r"""
   _____________             ~ ~ ~
  | [] [] [] [] |____________/ ~ ~
  |_____________|_| CUDA |_|_|
    (o)     (o)    (o) (o)
 =#=#=#=#=#=#=#=#=#=#=#=#=#=#=#=#=
 signaltrain-tpu-torch """ + version + "\n")
