-- o = -a, sign/zero-extended to WO bits before negation.
library ieee;
use ieee.std_logic_1164.all;
use ieee.numeric_std.all;
use work.da4ml_util.all;

entity negative is
    generic (WA : integer := 8; SA : integer := 1; WO : integer := 9);
    port (
        a : in std_logic_vector(WA - 1 downto 0);
        o : out std_logic_vector(WO - 1 downto 0)
    );
end entity;

architecture rtl of negative is
    constant WI : integer := imax(WO, WA) + 1;
    signal ea, neg : signed(WI - 1 downto 0);
begin
    ea <= ext(a, SA, WI);
    neg <= -ea;
    o <= std_logic_vector(neg(WO - 1 downto 0));
end architecture;
