"""The strict rung: every block output is carried as exact int32."""


def carry(net, a, target):
    return a
